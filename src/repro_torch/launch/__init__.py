"""Launchers of the port (``src/repro/launch/``): ``serve``, ``train``."""

"""Checkpoints of the train state (``src/repro/checkpoint/``)."""

"""Synthetic token data for training (``src/repro/data/``)."""

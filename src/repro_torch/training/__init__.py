"""Training: AdamW and the train step (``src/repro/training/``)."""

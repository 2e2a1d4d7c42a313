"""The port's benchmark: free-running tuning campaigns on the card.

``run.py`` is the entry; ``harness.py`` runs one cell; ``drivers/``,
``end_to_end/`` and ``metrics/`` hold one file a driver and a metric,
found by name; ``reference/`` is the yardstick: the plain reference, the
budget rule and the scan's byte count.
"""

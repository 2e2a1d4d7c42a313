"""The paper's loop in the port: spaces, caches, runners, strategies,
methodology, recording, and the torch replay engine (``engine_torch``).

Port of ``src/repro/core/``: each module keeps its reference's name.
"""

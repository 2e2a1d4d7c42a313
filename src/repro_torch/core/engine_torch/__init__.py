"""Replay engine on the card (the simulator's device half).

Port of ``src/repro/core/engine_jax/__init__.py``: ``ReplayEngine`` behind
``SimulationRunner(engine="torch")``,
``replay_many`` for fused multi-run workloads, and ``drive_fused``
(``campaign.py``), which drives whole campaigns of array-native strategies
(``FUSED_STRATEGIES``) with one budget-scan launch a segment of all of a
group's runs; ``fuse_reason`` says why a driver cannot take that path.
The compiled space's row -> cache-row bridge and the cache's value/charge
columns live as device tensors, and the hand-written kernel
``csrc/budget_scan.cu`` does the budget accounting with the exact
left-to-right float64 additions of the numpy engine. Given identical told
observations, scores and traces are **bit-identical** to the numpy path,
which stays the parity oracle.

Unlike the reference, nothing here degrades: a runner asked for the torch
engine on the card either launches the kernel or raises. On the CPU
(``device="cpu"``) the same code runs the kernel's plain PyTorch version.

Free-running strategies (``strategies.py``: ``free_run`` over
``FREE_RUN_STRATEGIES``, the GA, PSO, DE and random search) step R runs
through G generations with one budget-scan launch a generation, over the
compiled space's device tables (``SpaceTables``). They are only
statistically equivalent to the numpy strategies; pinned seeds reproduce
bit for bit on one device.
"""
from __future__ import annotations

import torch

from .campaign import FUSED_STRATEGIES, FusedRun  # noqa: F401
from .campaign import drive_fused, fuse_reason  # noqa: F401
from .replay import (ReplayEngine, budget_scan, budget_scan_plain,  # noqa: F401
                     replay_many)
from .strategies import FREE_RUN_STRATEGIES, free_run  # noqa: F401
from .tables import (ReplayTables, SpaceTables, replay_tables,  # noqa: F401
                     space_tables)


def engine_available() -> bool:
    """Whether a CUDA device of compute capability 9.x (Hopper, the
    kernels' ``sm_90a`` target) is present. A probe for callers that want
    to know; no entry point switches on it."""
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability(0)[0] == 9)

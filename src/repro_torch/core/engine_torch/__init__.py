"""Replay engine on the card (the simulator's device half).

Port of ``src/repro/core/engine_jax/__init__.py``, replay-from-log only:
``ReplayEngine`` behind ``SimulationRunner(engine="torch")`` and
``replay_many`` for fused multi-run workloads. The compiled space's
row -> cache-row bridge and the cache's value/charge columns live as
device tensors, and the hand-written kernel ``csrc/budget_scan.cu`` does
the budget accounting with the exact left-to-right float64 additions of the
numpy engine. Given identical told observations, scores and traces are
**bit-identical** to the numpy path, which stays the parity oracle.

Unlike the reference, nothing here degrades: a runner asked for the torch
engine on the card either launches the kernel or raises. On the CPU
(``device="cpu"``) the same code runs the kernel's plain PyTorch version.
Free-running strategies and device-fused campaigns wait for later slices.
"""
from __future__ import annotations

import torch

from .replay import (ReplayEngine, budget_scan, budget_scan_plain,  # noqa: F401
                     replay_many)
from .tables import ReplayTables, replay_tables  # noqa: F401


def engine_available() -> bool:
    """Whether a CUDA device of compute capability 9.x (Hopper, the
    kernels' ``sm_90a`` target) is present. A probe for callers that want
    to know; no entry point switches on it."""
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability(0)[0] == 9)

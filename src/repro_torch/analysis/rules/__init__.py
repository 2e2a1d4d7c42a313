"""Rule registry: one module per invariant family.

Port copy of ``src/repro/analysis/rules/__init__.py``, unchanged.

Order matters only for the report (it is re-sorted by position anyway);
the registry is the single place a new rule module plugs in.
"""
from __future__ import annotations

from . import device_sync, f64, ordering, pickle_safety, protocol, rng

ALL_RULES = (
    rng.ModuleLevelDraw,
    rng.TimeSeededRng,
    rng.DrawInSetIteration,
    pickle_safety.DeviceCacheNotDropped,
    pickle_safety.StateDeviceAttr,
    device_sync.DeviceSyncInLoop,
    f64.ParallelScanOnDevice,
    f64.ReductionWithoutDtype,
    f64.Float32Literal,
    protocol.DirectRunnerCall,
    protocol.StateRetainsRuntime,
    ordering.UnsortedDirectoryIteration,
    ordering.SetOrderedIteration,
    ordering.ImportTimeEnvMutation,
)

"""Device-resident mirrors of the cache columns for the replay kernel.

Port of ``src/repro/core/engine_jax/tables.py`` (replay tables only; the
free-running ``SpaceTables`` wait for the free-running slice). The numpy
arrays stay the source of truth; these are one-time copies to the
runner's device, memoized single-entry on ``CacheColumns._device`` with the
same protocol as ``CacheColumns.rows_for_space``. They are never pickled:
``CacheColumns`` drops the memo in ``__getstate__``, so a process-pool
worker rebuilds its tables on whatever device it has.

Every float table is ``torch.float64`` and every index ``torch.int32``, set
explicitly: a float32 copy of the charge column would break the bit parity
with the numpy engine.
"""
from __future__ import annotations

import numpy as np
import torch


class ReplayTables:
    """Replay-from-log tables for one (CacheColumns, CompiledSpace, device)
    triple: the space-row -> cache-row bridge plus the value/charge
    columns."""

    __slots__ = ("n_valid", "device", "col_of_row", "time_s", "charge_s")

    def __init__(self, cols, compiled, device: str):
        col_map = cols.rows_for_space(compiled)
        self.device = device
        self.col_of_row = torch.tensor(np.asarray(col_map, dtype=np.int32),
                                       dtype=torch.int32, device=device)
        self.time_s = torch.tensor(cols.time_s, dtype=torch.float64,
                                   device=device)
        self.charge_s = torch.tensor(cols.charge_s, dtype=torch.float64,
                                     device=device)
        self.n_valid = int(compiled.n_valid)


def replay_tables(cols, compiled, device: str) -> ReplayTables:
    """Memoized ``ReplayTables`` (single-entry, keyed by compiled-space
    identity and device — like ``CacheColumns.rows_for_space``)."""
    memo = cols._device
    if memo is not None and memo[0] is compiled and memo[1] == device:
        return memo[2]
    tables = ReplayTables(cols, compiled, device)
    cols._device = (compiled, device, tables)
    return tables

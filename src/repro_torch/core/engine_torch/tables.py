"""Device-resident mirrors of the cache columns and the compiled space.

Port of ``src/repro/core/engine_jax/tables.py``. The numpy arrays stay the
source of truth; these are one-time copies to a device, memoized
single-entry on their host objects: ``ReplayTables`` on
``CacheColumns._device`` (keyed by compiled space and device, the same
protocol as ``CacheColumns.rows_for_space``), ``SpaceTables`` on
``CompiledSpace._device`` (keyed by device). They are never pickled: both
hosts drop the memo in ``__getstate__``, so a process-pool worker rebuilds
its tables on whatever device it has.

Every float table is ``torch.float64`` and every row index
``torch.int32``, set explicitly: a float32 copy of the charge column
would break the bit parity with the numpy engine. The flat strides are
``torch.int64``, as the reference's.
"""
from __future__ import annotations

import numpy as np
import torch


class ReplayTables:
    """Replay-from-log tables for one (CacheColumns, CompiledSpace, device)
    triple: the space-row -> cache-row bridge plus the value/charge
    columns. ``has_miss`` says whether some space row has no recording."""

    __slots__ = ("n_valid", "device", "col_of_row", "time_s", "charge_s",
                 "has_miss")

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
        self.has_miss = bool((col_map < 0).any()) if len(col_map) else False


class SpaceTables:
    """Free-running tables for one ``CompiledSpace`` on one device: the
    value-index matrix, the validity lookup and the strides (decode and
    repair on the device)."""

    __slots__ = ("n_valid", "n_tunables", "cards", "device", "vidx",
                 "row_of_flat", "strides", "x_hi")

    def __init__(self, compiled, device: str):
        self.device = device
        self.vidx = torch.tensor(np.asarray(compiled.vidx, dtype=np.int32),
                                 dtype=torch.int32, device=device)
        self.row_of_flat = torch.tensor(compiled.row_of_flat,
                                        dtype=torch.int32, device=device)
        self.strides = torch.tensor(compiled.strides_np, dtype=torch.int64,
                                    device=device)
        self.x_hi = torch.tensor(compiled._x_hi, dtype=torch.float64,
                                 device=device)
        self.n_valid = int(compiled.n_valid)
        self.n_tunables = int(compiled.n_tunables)
        self.cards = tuple(compiled.cards)


def replay_tables(cols, compiled, device: str) -> ReplayTables:
    """Memoized ``ReplayTables`` (single-entry, keyed by compiled-space
    identity and device — like ``CacheColumns.rows_for_space``)."""
    memo = cols._device
    if memo is not None and memo[0] is compiled and memo[1] == device:
        return memo[2]
    tables = ReplayTables(cols, compiled, device)
    cols._device = (compiled, device, tables)
    return tables


def space_tables(compiled, device: str) -> SpaceTables:
    """Memoized ``SpaceTables`` on the compiled space itself (single-entry,
    keyed by device)."""
    memo = compiled._device
    if memo is not None and memo[0] == device:
        return memo[1]
    tables = SpaceTables(compiled, device)
    compiled._device = (device, tables)
    return tables

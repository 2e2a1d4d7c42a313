"""RowBatch: a batch of configs as integer rows of a compiled space.

This is how index-native strategies hand a generation to a runner without
materializing value tuples: ``SimulationRunner`` recognizes the type and
resolves the whole batch through row-indexed arrays (``runner._run_rows``),
while any other runner — live, cost-model, recording, the meta level's
``FunctionRunner`` — simply iterates it and receives ordinary value tuples
(``Sequence`` semantics), keeping the ``BatchRunner`` contract intact.

Pickling degrades to a plain list of value tuples: a RowBatch only ever
appears transiently (an in-flight ask), and shipping the compiled arrays
inside a mid-run checkpoint would bloat it for data the resume path
regenerates anyway.

Port copy of ``src/repro/core/space/rows.py``
and kept as its own copy: the port imports nothing of ``repro``.
"""
from __future__ import annotations

from collections.abc import Sequence

import numpy as np


class RowBatch(Sequence):
    __slots__ = ("compiled", "rows")

    def __init__(self, compiled, rows):
        # rows stays whatever sequence the caller built (tuple, list, or
        # ndarray — CSR slices arrive as arrays, single moves as tuples);
        # normalizing eagerly would cost an asarray per ask on the hottest
        # single-config path (simulated annealing's walk)
        self.compiled = compiled
        self.rows = rows

    def row_list(self) -> list:
        rows = self.rows
        return rows.tolist() if isinstance(rows, np.ndarray) else list(rows)

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return RowBatch(self.compiled, self.rows[i])
        return self.compiled.configs[int(self.rows[i])]

    def __iter__(self):
        configs = self.compiled.configs
        for r in self.row_list():
            yield configs[r]

    def __reduce__(self):
        # serialize as the value tuples this batch denotes (see docstring)
        return (list, (list(self),))

    def __repr__(self):
        return f"RowBatch({self.compiled.name!r}, n={len(self.rows)})"

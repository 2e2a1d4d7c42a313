"""Blocked vectorized space enumeration: Cartesian product -> CompiledSpace.

The legacy enumeration was a recursive depth-first product with a Python
dict built per leaf. Here the product is never materialized config-by-
config: flat Cartesian indices are processed in numpy chunks, the value-
index matrix of each chunk comes from stride arithmetic, and only the
constraint predicates themselves still run per row (they are arbitrary
Python callables over config dicts). Two fast paths skip even that:

  * no constraints — the whole product is valid; the bitmap is constant;
  * a single membership constraint (caches loaded from disk reconstruct
    their space as "config id is in the recorded result set",
    ``cache._Membership``) — the member keys are parsed straight into flat
    indices, making compilation O(n_valid) instead of O(cartesian) with a
    string join per config.

Enumeration order is identical to the legacy DFS: ascending flat index in
C order (last tunable fastest). Everything downstream (row numbering,
``valid_configs``, random-fallback draws) depends on that order.

Port copy of ``src/repro/core/space/compile.py``
and kept as its own copy: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import time
from typing import Sequence

import numpy as np

from ..tunable import Constraint, Tunable
from .compiled import CompiledSpace

# constraint evaluation block: large enough to amortize the per-chunk numpy
# calls, small enough that the object columns stay cache-resident
_CHUNK = 1 << 16


def _strides(cards: Sequence[int]) -> tuple:
    """C-order strides (last tunable fastest) — the DFS enumeration order."""
    out = [1] * len(cards)
    for i in range(len(cards) - 2, -1, -1):
        out[i] = out[i + 1] * cards[i + 1]
    return tuple(out)


def _membership_flats(tunables: Sequence[Tunable], names: tuple,
                      present) -> np.ndarray:
    """Parse membership keys (``"v1,v2,..."``) straight into sorted flat
    indices. Keys that do not decode to a Cartesian member are skipped —
    the DFS could never have produced them either."""
    strides = _strides([t.cardinality for t in tunables])
    flats = []
    n = len(tunables)
    for key in present:
        parts = key.split(",")
        if len(parts) != n:
            continue
        flat = 0
        for t, s, stride in zip(tunables, parts, strides):
            try:
                v = t.from_str(s)
            except KeyError:
                flat = -1
                break
            flat += t.position[v] * stride
        if flat >= 0:
            flats.append(flat)
    arr = np.unique(np.asarray(flats, dtype=np.int64))
    return arr


def compile_space(tunables: Sequence[Tunable],
                  constraints: Sequence[Constraint] = (),
                  name: str = "space") -> CompiledSpace:
    """Compile a constrained space into array form (see module docstring).

    Returns a :class:`CompiledSpace` whose ``compile_seconds`` records the
    wall cost (surfaced by ``python -m repro spaces`` and the
    ``space_compile`` benchmark component).
    """
    t0 = time.perf_counter()
    tunables = tuple(tunables)
    constraints = tuple(constraints)
    cards = tuple(t.cardinality for t in tunables)
    strides = _strides(cards)
    cartesian = 1
    for c in cards:
        cartesian *= c
    names = tuple(t.name for t in tunables)

    bitmap = np.zeros(cartesian, dtype=bool)
    member_fn = constraints[0].fn if len(constraints) == 1 else None
    if not constraints:
        bitmap[:] = True
        valid_flat = np.arange(cartesian, dtype=np.int64)
    elif (getattr(member_fn, "present", None) is not None
            and tuple(getattr(member_fn, "names", ())) == names
            # str collisions (1 vs "1") would make key parsing lossy where
            # the join-based membership predicate is not; fall back then
            and all(len(t._by_str) == t.cardinality for t in tunables)):
        valid_flat = _membership_flats(tunables, names, member_fn.present)
        bitmap[valid_flat] = True
    else:
        value_cols = [np.array(t.values, dtype=object) for t in tunables]
        for start in range(0, cartesian, _CHUNK):
            flats = np.arange(start, min(start + _CHUNK, cartesian),
                              dtype=np.int64)
            cols = [value_cols[i][(flats // strides[i]) % cards[i]].tolist()
                    for i in range(len(tunables))]
            ok = bitmap[start:start + len(flats)]
            for j, vals in enumerate(zip(*cols)):
                d = dict(zip(names, vals))
                ok[j] = all(c(d) for c in constraints)
        valid_flat = np.nonzero(bitmap)[0].astype(np.int64)

    vidx = np.empty((len(valid_flat), len(tunables)), dtype=np.int32)
    for i in range(len(tunables)):
        vidx[:, i] = (valid_flat // strides[i]) % cards[i]
    return CompiledSpace(tunables, constraints, name, cards, strides,
                         cartesian, valid_flat, vidx, bitmap,
                         compile_seconds=time.perf_counter() - t0)

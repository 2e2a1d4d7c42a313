"""Nearest-valid repair: single-move order tables + flat-index BFS.

The legacy ``nearest_valid`` ran a breadth-first search over single-tunable
moves (depth 3, frontier capped at 256) with a dict-memoized outcome and a
random-restart fallback. The search itself draws nothing from the rng, so
its outcome is a pure function of the starting config — here it runs over
flat Cartesian indices against the validity bitmap, with the per-(tunable,
index) move orders precomputed, and memoizes into a flat int32 table
(including the "BFS exhausted" outcome, which the scalar code recomputed
on every visit; only the *fallback draw* stays per-call, in the exact
scalar order).

Move order is the legacy one: per frontier config, tunables in declaration
order; per tunable, candidate indices sorted by distance from the current
index (ties: smaller index first, which includes the no-op move first —
always already seen, always skipped, exactly as before).

Port copy of ``src/repro/core/space/repair.py``
and kept as its own copy: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import numpy as np

UNSET = -2      # memo sentinel: repair not yet computed
FALLBACK = -1   # memo value: depth-3 BFS exhausted -> random fallback

_DEPTH = 3
_FRONTIER_CAP = 256


def make_state(cs) -> tuple:
    """(memo, move_orders) for one compiled space, allocated lazily on the
    first repair. ``memo`` is flat-indexed over the Cartesian product;
    ``move_orders[i][j]`` is the full candidate order for tunable ``i`` at
    value index ``j`` (the no-op first, like the scalar sort)."""
    memo = np.full(cs.cartesian_size, UNSET, dtype=np.int32)
    move_orders = tuple(
        tuple(tuple(sorted(range(card), key=lambda k: abs(k - j)))
              for j in range(card))
        for card in cs.cards)
    return memo, move_orders


def bfs(cs, move_orders, flat0: int) -> int:
    """The scalar BFS, verbatim, on flat indices: returns the repaired row
    or ``FALLBACK`` when depth-3 search exhausts."""
    bitmap = cs.bitmap
    row_of_flat = cs.row_of_flat
    strides = cs.strides
    cards = cs.cards
    n = cs.n_tunables
    seen = {flat0}
    frontier = [flat0]
    for _depth in range(_DEPTH):
        nxt: list[int] = []
        for f in frontier:
            for i in range(n):
                stride = strides[i]
                j = (f // stride) % cards[i]
                base = f - j * stride
                for k in move_orders[i][j]:
                    ff = base + k * stride
                    if ff in seen:
                        continue
                    seen.add(ff)
                    if bitmap[ff]:
                        return int(row_of_flat[ff])
                    nxt.append(ff)
        frontier = nxt[:_FRONTIER_CAP]
    return FALLBACK

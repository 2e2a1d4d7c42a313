"""CSR neighbor tables: whole neighborhoods as precomputed index slices.

The legacy space built each config's neighbor list lazily — tuple slicing
plus a constraint call per candidate, memoized per (config, mode) in an
unbounded dict. Here both neighbor semantics compile once into CSR form
(``indptr`` of length n_valid+1, ``indices`` of total degree), built in
row blocks from pure stride arithmetic against the validity bitmap.

Order is part of the contract (simulated annealing indexes ``nbrs[k]`` by
an rng draw, so it is rng-stream-visible): per row, candidates appear
tunable-major in declaration order; within a tunable, ordered by distance
in the value order with the smaller index first on ties (``hamming``), or
``j-1`` then ``j+1`` (``strictly_adjacent``) — exactly the legacy
enumeration.

Port copy of ``src/repro/core/space/neighbors.py``
and kept as its own copy: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import numpy as np

_BLOCK = 4096


def _cand_table(card: int, strictly_adjacent: bool) -> np.ndarray:
    """(card, width) candidate value-index table per current index ``j``;
    -1 pads impossible moves (value-set edges)."""
    if strictly_adjacent:
        table = np.full((card, 2), -1, dtype=np.int64)
        for j in range(card):
            pos = 0
            for k in (j - 1, j + 1):
                if 0 <= k < card:
                    table[j, pos] = k
                    pos += 1
        return table
    table = np.empty((card, max(card - 1, 0)), dtype=np.int64)
    for j in range(card):
        table[j] = sorted((k for k in range(card) if k != j),
                          key=lambda k: abs(k - j))
    return table


def build_csr(cs, strictly_adjacent: bool) -> tuple:
    """Build one semantics' CSR table for a ``CompiledSpace``."""
    tables = [_cand_table(c, strictly_adjacent) for c in cs.cards]
    indptr = np.zeros(cs.n_valid + 1, dtype=np.int64)
    chunks: list[np.ndarray] = []
    for start in range(0, cs.n_valid, _BLOCK):
        stop = min(start + _BLOCK, cs.n_valid)
        V = cs.vidx[start:stop]
        F = cs.valid_flat[start:stop]
        cols = []
        for i in range(cs.n_tunables):
            cand = tables[i][V[:, i]]              # (m, width)
            if cand.shape[1] == 0:
                continue
            pad = cand < 0
            delta = (cand - V[:, i:i + 1].astype(np.int64)) * cs.strides[i]
            flat = F[:, None] + np.where(pad, 0, delta)
            rows = cs.row_of_flat[flat].astype(np.int64)
            cols.append(np.where(pad, -1, rows))
        if not cols:
            continue
        block = np.hstack(cols)                    # (m, S), legacy order
        mask = block >= 0
        indptr[start + 1:stop + 1] = mask.sum(axis=1)
        chunks.append(block[mask])                 # row-major == in-order
    np.cumsum(indptr, out=indptr)
    indices = (np.concatenate(chunks).astype(np.int32) if chunks
               else np.empty(0, dtype=np.int32))
    return indptr, indices

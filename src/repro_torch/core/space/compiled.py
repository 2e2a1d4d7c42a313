"""The array-backed search space: integer rows as the native config form.

A ``CompiledSpace`` numbers the valid configs 0..n_valid-1 in enumeration
order (ascending flat Cartesian index — the legacy DFS order). Every hot
query is row-native:

  * ``neighbors_rows(row, mode)``   — one CSR slice (no per-call work)
  * ``random_row(rng)``             — the legacy rejection sampler, drawing
                                      from ``rng`` in the exact same order
  * ``repair_vidx / decode_rows``   — nearest-valid repair over precomputed
                                      single-move tables (repair.py)
  * ``rows_of_vidx``                — batch index-tuple -> row gather

Value tuples (``configs``), config-id strings (``ids``), and their inverse
maps are lazy row-indexed tables: they exist for the serialization /
recording / journal boundary and for human-facing output, never for the
search loop itself. RNG behaviour is a compatibility contract: every
``rng`` draw here happens at the same point in the stream, with the same
modulus, as the pre-compilation scalar implementation
(``core.space.reference``), so traces are bit-identical.

Port copy of ``src/repro/core/space/compiled.py``
and kept as its own copy: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import random
from typing import Sequence

import numpy as np

from ..tunable import Config, Constraint, Tunable
from . import neighbors as _neighbors
from . import repair as _repair

NEIGHBOR_MODES = ("hamming", "strictly_adjacent")


class CompiledSpace:
    """Immutable compiled form of one constrained search space. Build via
    ``core.space.compile_space`` (or ``SearchSpace.compiled``)."""

    def __init__(self, tunables: Sequence[Tunable],
                 constraints: Sequence[Constraint], name: str,
                 cards: tuple, strides: tuple, cartesian_size: int,
                 valid_flat: np.ndarray, vidx: np.ndarray,
                 bitmap: np.ndarray, compile_seconds: float = 0.0):
        self.tunables = tuple(tunables)
        self.constraints = tuple(constraints)
        self.name = name
        self.cards = cards                      # per-tunable cardinalities
        self.strides = strides                  # C-order flat strides
        self.strides_np = np.asarray(strides, dtype=np.int64)
        self.cartesian_size = cartesian_size
        self.n_tunables = len(self.tunables)
        self.valid_flat = valid_flat            # (n_valid,) sorted flats
        self.vidx = vidx                        # (n_valid, T) value indices
        self.bitmap = bitmap                    # (cartesian,) validity
        self.n_valid = len(valid_flat)
        self.compile_seconds = compile_seconds
        row_of_flat = np.full(cartesian_size, -1, dtype=np.int32)
        row_of_flat[valid_flat] = np.arange(self.n_valid, dtype=np.int32)
        self.row_of_flat = row_of_flat
        # rejection sampling draws an *index* per tunable with the same
        # rng.choice modulus the scalar sampler used on the value tuple
        self._choice_seqs = tuple(tuple(range(c)) for c in cards)
        self._x_hi = np.array([c - 1 for c in cards], dtype=np.float64)
        # lazy row-indexed boundary tables
        self._configs: list | None = None
        self._idx_tuples: list | None = None
        self._ids: list | None = None
        self._id_to_row: dict | None = None
        self._csr: dict = {}
        self._repair_state: tuple | None = None
        # idx-tuple -> row (or FALLBACK) front cache: population strategies
        # repair the same bred children every generation, and the tuple
        # dict hit is ~4x cheaper than recomputing the flat index (the old
        # implementation's _repair/_validity dict caches, consolidated)
        self._repair_tuples: dict = {}
        # device-tensor memo (reserved for core.engine_torch), never pickled
        self._device = None

    def __getstate__(self) -> dict:
        """Pickle only the compiled core. Lazy boundary tables rebuild on
        demand, and device tensors must never cross a process boundary: a
        pool worker re-materializes them on the device it actually has,
        instead of inheriting handles to memory of another process."""
        state = self.__dict__.copy()
        state.update(_configs=None, _idx_tuples=None, _ids=None,
                     _id_to_row=None, _csr={}, _repair_state=None,
                     _repair_tuples={}, _device=None)
        return state

    # ------------------------------------------------------- boundary tables
    @property
    def configs(self) -> list:
        """Row -> value tuple. The only place value tuples materialize."""
        if self._configs is None:
            cols = [np.array(t.values, dtype=object)[self.vidx[:, i]].tolist()
                    for i, t in enumerate(self.tunables)]
            self._configs = list(zip(*cols)) if cols else []
        return self._configs

    @property
    def idx_tuples(self) -> list:
        """Row -> value-index tuple (pure-int genomes for GA-style ops)."""
        if self._idx_tuples is None:
            self._idx_tuples = list(map(tuple, self.vidx.tolist()))
        return self._idx_tuples

    @property
    def ids(self) -> list:
        """Row -> config-id string (the T4 cache key form)."""
        if self._ids is None:
            self._ids = [",".join(map(str, cfg)) for cfg in self.configs]
        return self._ids

    @property
    def id_to_row(self) -> dict:
        if self._id_to_row is None:
            self._id_to_row = {k: i for i, k in enumerate(self.ids)}
        return self._id_to_row

    # ------------------------------------------------------------ row lookup
    def flat_of_vidx(self, idx: Sequence[int]) -> int:
        flat = 0
        for k, stride in zip(idx, self.strides):
            flat += k * stride
        return flat

    def row_of_vidx(self, idx: Sequence[int]) -> int:
        """Row for one value-index tuple; -1 when the config is invalid."""
        return int(self.row_of_flat[self.flat_of_vidx(idx)])

    def rows_of_vidx(self, mat) -> np.ndarray:
        """Batch row gather for a (P, T) value-index matrix."""
        flats = np.asarray(mat, dtype=np.int64) @ self.strides_np
        return self.row_of_flat[flats].astype(np.int64)

    def vidx_of_config(self, config: Config) -> tuple | None:
        """Value tuple -> value-index tuple; None if any value is not in
        its tunable's value set (out-of-vocabulary)."""
        idx = []
        for t, v in zip(self.tunables, config):
            pos = t.position.get(v)
            if pos is None:
                return None
            idx.append(pos)
        return tuple(idx)

    def row_of_config(self, config: Config) -> int:
        """Value tuple -> row; -1 for invalid or out-of-vocab configs."""
        if len(config) != self.n_tunables:
            return -1
        idx = self.vidx_of_config(config)
        return -1 if idx is None else self.row_of_vidx(idx)

    def x_of_row(self, row: int) -> np.ndarray:
        """Row -> float index vector (the continuous-relaxation coding)."""
        return self.vidx[row].astype(np.float64)

    # -------------------------------------------------------------- sampling
    def random_row(self, rng: random.Random) -> int:
        """Uniform over valid rows — draw-for-draw identical to the scalar
        rejection sampler (64 per-tunable ``rng.choice`` rounds, then one
        ``rng.randrange`` over the enumeration)."""
        bitmap, row_of_flat = self.bitmap, self.row_of_flat
        strides = self.strides
        for _ in range(64):
            flat = 0
            for seq, stride in zip(self._choice_seqs, strides):
                flat += rng.choice(seq) * stride
            if bitmap[flat]:
                return int(row_of_flat[flat])
        if not self.n_valid:
            raise ValueError(f"space {self.name!r} has no valid configs")
        return rng.randrange(self.n_valid)

    # ------------------------------------------------------------- neighbors
    def csr(self, strictly_adjacent: bool = False) -> tuple:
        """(indptr, indices) CSR neighbor table for one semantics, built
        once on first use."""
        mode = bool(strictly_adjacent)
        hit = self._csr.get(mode)
        if hit is None:
            hit = self._csr[mode] = _neighbors.build_csr(self, mode)
        return hit

    def neighbors_rows(self, row: int,
                       strictly_adjacent: bool = False) -> np.ndarray:
        """Valid neighbor rows of ``row`` in the exact legacy order
        (tunable-major, then by distance in the value order)."""
        indptr, indices = self.csr(strictly_adjacent)
        return indices[indptr[row]:indptr[row + 1]]

    # ---------------------------------------------------------------- repair
    def _repair(self) -> tuple:
        if self._repair_state is None:
            self._repair_state = _repair.make_state(self)
        return self._repair_state

    def repair_flat(self, flat: int, rng: random.Random) -> int:
        """Nearest-valid row for one (invalid) flat index: memoized BFS
        over single-tunable moves, then the random-restart fallback — the
        only part that draws from ``rng``, in the exact scalar order."""
        row = int(self.row_of_flat[flat])
        if row >= 0:
            return row
        memo, move_orders = self._repair()
        row = int(memo[flat])
        if row == _repair.UNSET:
            row = _repair.bfs(self, move_orders, flat)
            memo[flat] = row
        if row >= 0:
            return row
        return self.random_row(rng)

    def repair_vidx(self, idx: Sequence[int], rng: random.Random) -> int:
        """Nearest-valid row for a value-index tuple (``nearest_valid``).

        The deterministic outcome (valid row, or BFS result) is memoized
        per tuple; only the random-restart fallback stays per-call (it
        draws from ``rng`` — caching it would correlate runs)."""
        idx = tuple(idx)
        hit = self._repair_tuples.get(idx)
        if hit is None:
            flat = self.flat_of_vidx(idx)
            row = int(self.row_of_flat[flat])
            if row < 0:
                memo, move_orders = self._repair()
                row = int(memo[flat])
                if row == _repair.UNSET:
                    row = _repair.bfs(self, move_orders, flat)
                    memo[flat] = row
            hit = self._repair_tuples[idx] = row
        if hit >= 0:
            return hit
        return self.random_row(rng)

    def repair_x(self, x, rng: random.Random) -> int:
        """Round/clip one continuous index vector and repair — the scalar
        ``from_indices`` + ``nearest_valid`` composition (Python ``round``:
        half-to-even, identical to the batched ``np.rint`` path)."""
        idx = tuple(max(0, min(c - 1, int(round(float(xi)))))
                    for xi, c in zip(x, self.cards))
        return self.repair_vidx(idx, rng)

    def decode_rows(self, x, rng: random.Random) -> np.ndarray:
        """Vectorized round/clip + repair of a (P, T) index matrix into
        rows — the ask half of a population strategy's batch step. Valid
        positions resolve in one gather; only invalid rows walk the repair
        tables, in row order, so fallback draws hit ``rng`` exactly as the
        per-particle scalar loop did."""
        x = np.asarray(x, dtype=np.float64)
        k = np.clip(np.rint(x), 0.0, self._x_hi).astype(np.int64)
        flats = k @ self.strides_np
        rows = self.row_of_flat[flats].astype(np.int64)
        for j in np.nonzero(rows < 0)[0].tolist():
            rows[j] = self.repair_flat(int(flats[j]), rng)
        return rows

    # ------------------------------------------------------------------ misc
    def stats(self) -> dict:
        """Per-space summary for ``python -m repro spaces`` and the docs:
        sizes, valid fraction, compile time, neighbor-degree distribution."""
        degrees = {}
        for label, mode in (("strictly_adjacent", True), ("hamming", False)):
            if self.n_valid:
                counts = np.diff(self.csr(mode)[0])
                degrees[label] = {
                    "min": int(counts.min()),
                    "median": float(np.median(counts)),
                    "mean": float(counts.mean()),
                    "max": int(counts.max()),
                }
            else:
                degrees[label] = {"min": 0, "median": 0.0, "mean": 0.0,
                                  "max": 0}
        return {
            "name": self.name,
            "n_tunables": self.n_tunables,
            "cartesian_size": self.cartesian_size,
            "n_valid": self.n_valid,
            "valid_fraction": (self.n_valid / self.cartesian_size
                               if self.cartesian_size else 0.0),
            "compile_seconds": self.compile_seconds,
            "degrees": degrees,
        }

    def __repr__(self):
        return (f"CompiledSpace({self.name!r}, valid={self.n_valid}/"
                f"{self.cartesian_size})")

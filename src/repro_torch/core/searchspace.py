"""Constrained discrete search spaces (paper Sec. III-A) — compiled facade.

The space is the Cartesian product of tunable value sets filtered by
constraints. Since the index-native refactor this module is a deprecation
shim: the public constructor and method signatures are unchanged, but every
hot query delegates to a lazily **compiled** array representation
(``core.space.CompiledSpace``) — a validity bitmap plus a
``(n_valid, n_tunables)`` value-index matrix built once by blocked
vectorized enumeration, CSR neighbor tables for both neighbor semantics,
and precomputed single-move repair tables. Integer row indices are the
native config form through the whole simulation hot path; this facade
translates between rows and the value-tuple/config-id forms at the API
boundary.

Key operations used by the optimization strategies (all signatures as
before the refactor, all results bit-identical to the frozen reference in
``core.space.reference``):
  - ``size`` / ``valid_configs``: enumeration of the valid space
  - ``random_config(rng)``: uniform sampling of valid configs (same rng
    draw order as the scalar rejection sampler)
  - ``neighbors(config)``: Hamming-adjacent valid configs, served as one
    CSR slice
  - ``nearest_valid`` / ``decode_batch``: repair through the move tables
  - ``to_indices`` / ``from_indices``: positional encoding used by
    continuous-relaxation strategies (PSO, differential evolution, dual
    annealing).

Index-native callers (the strategies, ``SimulationRunner``) should use
``space.compiled`` directly and exchange ``core.space.RowBatch`` batches;
the tuple-based methods here exist for external code, the scalar reference
engine, and serialization.

Port copy of ``src/repro/core/searchspace.py``
and kept as its own copy: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import random
from typing import Iterable, Mapping, Sequence

import numpy as np

from .space import CompiledSpace, compile_space
from .tunable import Config, Constraint, Tunable


class SearchSpace:
    def __init__(self, tunables: Sequence[Tunable], constraints: Sequence[Constraint] = (),
                 name: str = "space"):
        if not tunables:
            raise ValueError("search space needs at least one tunable")
        names = [t.name for t in tunables]
        if len(set(names)) != len(names):
            raise ValueError("duplicate tunable names")
        self.name = name
        self.tunables = tuple(tunables)
        self.constraints = tuple(constraints)
        self._names = tuple(names)
        self._index = {n: i for i, n in enumerate(names)}
        self._compiled: CompiledSpace | None = None
        # config-id memo for the tuple-keyed compat path (scalar engine,
        # out-of-tree callers); row-native code reads ``compiled.ids``
        self._id_cache: dict[Config, str] = {}

    # --------------------------------------------------------------- compiled
    @property
    def compiled(self) -> CompiledSpace:
        """The array-backed form, compiled on first use (and after
        unpickling — the arrays never cross process boundaries)."""
        cs = self._compiled
        if cs is None:
            cs = self._compiled = compile_space(self.tunables,
                                                self.constraints, self.name)
        return cs

    def __getstate__(self) -> dict:
        """Pickle without the compiled arrays or id memo: parallel
        campaigns ship spaces to worker processes once per pool, and
        recompiling there is cheaper than shipping bitmap + CSR tables."""
        state = self.__dict__.copy()
        state["_compiled"] = None
        state["_id_cache"] = {}
        return state

    # ------------------------------------------------------------------ views
    @property
    def names(self) -> tuple:
        return self._names

    def as_dict(self, config: Config) -> dict:
        return dict(zip(self._names, config))

    def from_dict(self, d: Mapping) -> Config:
        return tuple(d[n] for n in self._names)

    @property
    def cartesian_size(self) -> int:
        n = 1
        for t in self.tunables:
            n *= t.cardinality
        return n

    # ------------------------------------------------------------ enumeration
    def is_valid(self, config: Config) -> bool:
        """Validity as one bitmap probe (replaces the per-config dict
        cache; for hub spaces the membership constraint used to cost a
        string join per miss)."""
        if len(config) != len(self.tunables):
            return False
        cs = self.compiled
        idx = cs.vidx_of_config(config)
        if idx is None:  # some value outside its tunable's value set
            return False
        return bool(cs.bitmap[cs.flat_of_vidx(idx)])

    @property
    def valid_configs(self) -> list:
        return list(self.compiled.configs)

    @property
    def size(self) -> int:
        return self.compiled.n_valid

    def config_id(self, config: Config) -> str:
        """Stable string key for caches (T4 data uses stringified configs).

        Memoized per space; row-native code never calls this — it reads the
        precomputed ``compiled.ids`` table at the serialization boundary."""
        key = self._id_cache.get(config)
        if key is None:
            key = self._id_cache[config] = ",".join(str(v) for v in config)
        return key

    def config_ids(self, configs: Sequence[Config]) -> list[str]:
        """Batch ``config_id`` — one call for a whole generation (the
        tuple-keyed ``BatchRunner`` compat path)."""
        cache = self._id_cache
        out = []
        for config in configs:
            key = cache.get(config)
            if key is None:
                key = cache[config] = ",".join(str(v) for v in config)
            out.append(key)
        return out

    def config_from_id(self, key: str) -> Config:
        """Inverse of ``config_id`` via the per-tunable ``str(value) ->
        value`` tables (``Tunable.from_str``) — O(1) per value instead of
        the former O(cardinality) scan (it is called per record on journal
        resume and cache merge)."""
        return tuple(t.from_str(s)
                     for t, s in zip(self.tunables, key.split(",")))

    # --------------------------------------------------------------- sampling
    def random_config(self, rng: random.Random) -> Config:
        """Uniform over *valid* configs (same draws as the scalar sampler:
        rejection first, enumeration fallback)."""
        cs = self.compiled
        return cs.configs[cs.random_row(rng)]

    # ------------------------------------------------------------- neighbors
    def neighbors(self, config: Config, strictly_adjacent: bool = False) -> list:
        """Valid configs differing in exactly one tunable.

        ``strictly_adjacent``: restrict to numerically adjacent values in the
        tunable's declared order (Kernel Tuner's 'adjacent' neighbor method);
        otherwise all alternative values of each tunable are candidates,
        ordered by distance in the value order ('Hamming+ordered'). Served
        as one CSR row slice; invalid starting configs (allowed by the old
        API) fall back to the scalar enumeration.
        """
        cs = self.compiled
        row = cs.row_of_config(config)
        if row >= 0:
            configs = cs.configs
            return [configs[r] for r in
                    cs.neighbors_rows(row, strictly_adjacent).tolist()]
        return self._neighbors_scalar(config, strictly_adjacent)

    def _neighbors_scalar(self, config: Config,
                          strictly_adjacent: bool) -> list:
        """Legacy path for configs outside the compiled rows (invalid or
        out-of-vocabulary starting points)."""
        out: list[Config] = []
        for i, t in enumerate(self.tunables):
            j = t.index_of(config[i])
            if strictly_adjacent:
                cand = [k for k in (j - 1, j + 1) if 0 <= k < t.cardinality]
            else:
                cand = sorted((k for k in range(t.cardinality) if k != j),
                              key=lambda k: abs(k - j))
            for k in cand:
                c = config[:i] + (t.values[k],) + config[i + 1:]
                if self.is_valid(c):
                    out.append(c)
        return out

    # ---------------------------------------------------- index-vector coding
    def to_indices(self, config: Config) -> np.ndarray:
        return np.array([t.index_of(v) for t, v in zip(self.tunables, config)],
                        dtype=np.float64)

    def from_indices(self, x: Iterable) -> Config:
        """Round a continuous index vector to the nearest config (may be
        invalid; strategies repair via ``nearest_valid``)."""
        out = []
        for t, xi in zip(self.tunables, x):
            k = int(round(float(xi)))
            k = max(0, min(t.cardinality - 1, k))
            out.append(t.values[k])
        return tuple(out)

    def decode_batch(self, x: "np.ndarray", rng: random.Random) -> list:
        """Vectorized ``from_indices`` + ``nearest_valid`` over a (P, T)
        index matrix; repairs draw from ``rng`` exactly as the per-particle
        scalar loop did. Index-native callers use
        ``compiled.decode_rows`` and skip the tuple materialization."""
        cs = self.compiled
        configs = cs.configs
        return [configs[r] for r in cs.decode_rows(x, rng).tolist()]

    def nearest_valid(self, config: Config, rng: random.Random) -> Config:
        """Repair an invalid config: breadth-first over single-tunable
        moves (precomputed move tables, memoized outcome), then random
        restart drawing from ``rng`` in the exact scalar order."""
        cs = self.compiled
        idx = cs.vidx_of_config(config)
        if idx is None:
            return self._nearest_valid_oov(config, rng)
        flat = cs.flat_of_vidx(idx)
        if cs.bitmap[flat]:
            return config
        return cs.configs[cs.repair_flat(flat, rng)]

    def _nearest_valid_oov(self, config: Config, rng: random.Random) -> Config:
        """Legacy BFS for configs with out-of-vocabulary values (the move
        tables only cover the Cartesian product; the old code treated an
        unknown value as index 0)."""
        frontier = [config]
        seen = {config}
        for _depth in range(3):
            nxt: list[Config] = []
            for c in frontier:
                for i, t in enumerate(self.tunables):
                    j = t.index_of(c[i]) if c[i] in t.values else 0
                    order = sorted(range(t.cardinality),
                                   key=lambda k: abs(k - j))
                    for k in order:
                        cc = c[:i] + (t.values[k],) + c[i + 1:]
                        if cc in seen:
                            continue
                        seen.add(cc)
                        if self.is_valid(cc):
                            return cc
                        nxt.append(cc)
            frontier = nxt[:256]
        return self.random_config(rng)

    @property
    def bounds(self) -> list:
        """Index-space bounds [(0, card-1), ...] for continuous strategies."""
        return [(0.0, float(t.cardinality - 1)) for t in self.tunables]

    def __repr__(self):
        return (f"SearchSpace({self.name!r}, tunables={len(self.tunables)}, "
                f"cartesian={self.cartesian_size})")

"""The frozen pre-compilation search space — scalar parity reference.

This is the ``core.searchspace.SearchSpace`` implementation exactly as it
existed before the compiled ``core.space`` subsystem replaced it:
recursive-DFS enumeration, lazy per-config dict caches for validity /
neighbors / repair / ids. It is kept in-tree — like the scalar simulation
engine (``SimulationRunner(columnar=False)``) and the ``*_scalar``
methodology functions — as the oracle the compiled path is pinned against:

  * tests/test_space_compiled.py sweeps compiled ``neighbors`` /
    ``is_valid`` / ``random_config`` / ``decode_batch`` / ``nearest_valid``
    against this class, element-for-element and rng-draw-for-draw;
  * benchmarks/bench_simulate.py uses it as the denominator of the
    ``space_compile`` and ``local_search`` components.

Do not "improve" this module; its value is that it does not move.

Port copy of ``src/repro/core/space/reference.py``, line for line: the
port imports nothing of ``repro``, so its relative import now names
``repro_torch.core.tunable``. ``tests/test_torch_space_reference.py``
holds it against the reference's copy and pins the port's compiled
space against it.
"""
from __future__ import annotations

import random
from typing import Iterable, Mapping, Sequence

import numpy as np

from ..tunable import Config, Constraint, Tunable


class ReferenceSearchSpace:
    def __init__(self, tunables: Sequence[Tunable],
                 constraints: Sequence[Constraint] = (),
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
        self._valid: list[Config] | None = None
        self._valid_set: frozenset | None = None
        # hot-path caches: simulated tuning calls neighbors()/nearest_valid()
        # and config_id() millions of times on the same few thousand configs
        self._nbr_cache: dict[tuple, list[Config]] = {}
        self._repair_cache: dict[Config, Config] = {}
        self._id_cache: dict[Config, str] = {}
        self._validity_cache: dict[Config, bool] = {}
        self._decode_tables: tuple | None = None

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
        hit = self._validity_cache.get(config)
        if hit is None:
            hit = self._validity_cache[config] = self._compute_valid(config)
        return hit

    def _compute_valid(self, config: Config) -> bool:
        if len(config) != len(self.tunables):
            return False
        for t, v in zip(self.tunables, config):
            if v not in t.values:
                return False
        d = self.as_dict(config)
        return all(c(d) for c in self.constraints)

    def _enumerate(self) -> list[Config]:
        if self._valid is None:
            out: list[Config] = []
            # depth-first product with early constraint checks on full
            # configs; spaces here are <= ~1e6 cartesian, fine to enumerate.
            def rec(i: int, prefix: tuple):
                if i == len(self.tunables):
                    d = dict(zip(self._names, prefix))
                    if all(c(d) for c in self.constraints):
                        out.append(prefix)
                    return
                for v in self.tunables[i].values:
                    rec(i + 1, prefix + (v,))
            rec(0, ())
            self._valid = out
            self._valid_set = frozenset(out)
        return self._valid

    @property
    def valid_configs(self) -> list:
        return list(self._enumerate())

    @property
    def size(self) -> int:
        return len(self._enumerate())

    def config_id(self, config: Config) -> str:
        key = self._id_cache.get(config)
        if key is None:
            key = self._id_cache[config] = ",".join(str(v) for v in config)
        return key

    def config_ids(self, configs: Sequence[Config]) -> list[str]:
        cache = self._id_cache
        out = []
        for config in configs:
            key = cache.get(config)
            if key is None:
                key = cache[config] = ",".join(str(v) for v in config)
            out.append(key)
        return out

    def config_from_id(self, key: str) -> Config:
        parts = key.split(",")
        out = []
        for t, s in zip(self.tunables, parts):
            match = None
            for v in t.values:
                if str(v) == s:
                    match = v
                    break
            if match is None:
                raise KeyError(f"{s!r} not a value of {t.name!r}")
            out.append(match)
        return tuple(out)

    # --------------------------------------------------------------- sampling
    def random_config(self, rng: random.Random) -> Config:
        for _ in range(64):
            c = tuple(rng.choice(t.values) for t in self.tunables)
            if self.is_valid(c):
                return c
        valid = self._enumerate()
        if not valid:
            raise ValueError(f"space {self.name!r} has no valid configs")
        return valid[rng.randrange(len(valid))]

    # ------------------------------------------------------------- neighbors
    def neighbors(self, config: Config, strictly_adjacent: bool = False) -> list:
        key = (config, strictly_adjacent)
        hit = self._nbr_cache.get(key)
        if hit is not None:
            return hit
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
        self._nbr_cache[key] = out
        return out

    # ---------------------------------------------------- index-vector coding
    def to_indices(self, config: Config) -> np.ndarray:
        return np.array([t.index_of(v) for t, v in zip(self.tunables, config)],
                        dtype=np.float64)

    def from_indices(self, x: Iterable) -> Config:
        out = []
        for t, xi in zip(self.tunables, x):
            k = int(round(float(xi)))
            k = max(0, min(t.cardinality - 1, k))
            out.append(t.values[k])
        return tuple(out)

    def decode_batch(self, x: "np.ndarray", rng: random.Random) -> list:
        x = np.asarray(x, dtype=np.float64)
        if self._decode_tables is None:
            self._decode_tables = (
                [np.array(t.values, dtype=object) for t in self.tunables],
                np.array([t.cardinality - 1 for t in self.tunables],
                         dtype=np.float64))
        tables, hi = self._decode_tables
        k = np.clip(np.rint(x), 0.0, hi).astype(np.intp)
        columns = [tables[i][k[:, i]].tolist() for i in range(len(tables))]
        return [self.nearest_valid(c, rng) for c in zip(*columns)]

    def nearest_valid(self, config: Config, rng: random.Random) -> Config:
        if self.is_valid(config):
            return config
        hit = self._repair_cache.get(config)
        if hit is not None:
            return hit
        frontier = [config]
        seen = {config}
        for _depth in range(3):
            nxt: list[Config] = []
            for c in frontier:
                for i, t in enumerate(self.tunables):
                    j = t.index_of(c[i]) if c[i] in t.values else 0
                    order = sorted(range(t.cardinality), key=lambda k: abs(k - j))
                    for k in order:
                        cc = c[:i] + (t.values[k],) + c[i + 1:]
                        if cc in seen:
                            continue
                        seen.add(cc)
                        if self.is_valid(cc):
                            self._repair_cache[config] = cc
                            return cc
                        nxt.append(cc)
            frontier = nxt[:256]
        return self.random_config(rng)

    @property
    def bounds(self) -> list:
        return [(0.0, float(t.cardinality - 1)) for t in self.tunables]

    def __repr__(self):
        return (f"ReferenceSearchSpace({self.name!r}, "
                f"tunables={len(self.tunables)}, "
                f"cartesian={self.cartesian_size})")

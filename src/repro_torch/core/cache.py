"""T4-style results cache: the on-disk form of a brute-forced search space.

The paper stores hub results in the community T4 JSON format (FAIR sharing of
data in autotuning research [42]); files are compressed for portability
(Sec. III-D: "output files are compressed and decompressed automatically").
We implement a faithful, self-describing subset ("T4-mini"): per-config status,
raw repeated observations, mean objective, and compile time, plus enough
metadata to reconstruct the search space.

The cache is what the simulation mode replays (Sec. III-C): every segment of a
live evaluation (compile, run, overhead) is recorded so a tuning run can be
replayed with exact simulated-time accounting.

Port copy of ``src/repro/core/cache.py``
and kept as its own copy: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import dataclasses
import gzip
import json
import os
from typing import Mapping, Sequence

import numpy as np

try:  # optional: zstd gives the best ratio, but the stdlib must suffice
    import zstandard
except ImportError:  # pragma: no cover - depends on environment
    zstandard = None

from .searchspace import SearchSpace
from .tunable import Config, Constraint, Tunable

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
_GZIP_MAGIC = b"\x1f\x8b"


def _compress(payload: bytes, path: str) -> bytes:
    """Compress per extension. Without ``zstandard``, ``.zst`` files are
    written gzip-compressed instead — ``_decompress`` sniffs magic bytes, so
    the fallback stays round-trippable and portable."""
    if path.endswith(".zst"):
        if zstandard is not None:
            return zstandard.ZstdCompressor(level=9).compress(payload)
        return gzip.compress(payload, compresslevel=9)
    if path.endswith(".gz"):
        return gzip.compress(payload, compresslevel=9)
    return payload


def _decompress(payload: bytes, path: str) -> bytes:
    """Decompress by magic bytes (extension-agnostic: a ``.zst`` file written
    by the gzip fallback still loads)."""
    if payload[:4] == _ZSTD_MAGIC:
        if zstandard is None:
            raise RuntimeError(
                f"{path} is zstd-compressed but the 'zstandard' module is not "
                f"installed; install it or re-save the cache as .json/.json.gz")
        return zstandard.ZstdDecompressor().decompress(payload)
    if payload[:2] == _GZIP_MAGIC:
        return gzip.decompress(payload)
    return payload


class _Membership:
    """Picklable membership predicate for caches loaded from disk.

    Static constraints excluded configs from the brute force entirely, so
    membership in the results *is* the original validity predicate. A class
    (rather than a closure) so that reconstructed spaces — and the scorers
    built on them — can cross process boundaries in parallel campaigns."""

    def __init__(self, names: tuple, present: frozenset):
        self.names = names
        self.present = present

    def __call__(self, conf: Mapping) -> bool:
        return ",".join(str(conf[n]) for n in self.names) in self.present


@dataclasses.dataclass(frozen=True)
class CachedResult:
    status: str          # "ok" | "error"
    time_s: float        # mean objective (inf for error)
    times_s: tuple       # raw observations
    compile_s: float
    overhead_s: float = 0.0

    @property
    def charge_s(self) -> float:
        """Simulated seconds a live evaluation of this config would cost:
        compile + one execution of every recorded repeat + overhead."""
        return self.compile_s + sum(self.times_s) + self.overhead_s


def result_to_json(r: CachedResult) -> dict:
    """The T4-mini JSON form of one result (shared by cache files and
    recording shards: one schema, one reader/writer pair)."""
    return {
        "status": r.status,
        "time_s": (r.time_s if r.time_s != float("inf") else None),
        "times_s": list(r.times_s),
        "compile_s": r.compile_s,
        "overhead_s": r.overhead_s,
    }


def result_from_json(d: Mapping) -> CachedResult:
    return CachedResult(
        status=d["status"],
        time_s=(float("inf") if d["time_s"] is None else d["time_s"]),
        times_s=tuple(d["times_s"]),
        compile_s=d["compile_s"],
        overhead_s=d.get("overhead_s", 0.0),
    )


def membership_space(kernel: str, device: str,
                     tunables: Mapping[str, Sequence],
                     present: Sequence[str]) -> SearchSpace:
    """Reconstruct a search space whose validity predicate is membership in
    the recorded/brute-forced result set. Static constraints excluded
    configs from the brute force entirely, so membership in the results
    *is* the original validity predicate (runtime failures are present with
    status "error" — they belong to the space)."""
    tun = tuple(Tunable(n, tuple(v)) for n, v in tunables.items())
    member = Constraint(_Membership(tuple(tunables.keys()),
                                    frozenset(present)),
                        "config present in recorded results")
    return SearchSpace(tun, (member,), name=f"{kernel}@{device}")


class CacheColumns:
    """Columnar (array-backed) view of a cache's results.

    The simulation hot path — millions of replayed evaluations per
    hypertuning campaign — is dominated by per-evaluation dict lookups,
    attribute access, and the ``CachedResult.charge_s`` sum recomputed on
    every visit. This view lays the same data out once as contiguous numpy
    arrays plus a config-id hash table, so whole batches of configs resolve
    in one fancy-indexed gather (see ``runner.SimulationRunner.run_batch``
    and ``methodology.make_scorer``).

    Invariants:
      * row order == ``results`` insertion order (the same order the scalar
        path iterates, so fixed-order reductions stay bit-identical);
      * ``charge_s``/``run_s`` are computed with the *scalar* left-to-right
        reductions of ``CachedResult`` — never a numpy pairwise sum — so a
        gathered charge equals the scalar path's to the last bit;
      * the view is immutable; ``CacheFile`` invalidates and rebuilds it on
        mutation (``insert``) so a stale view can never serve lookups.
    """

    __slots__ = ("keys", "index", "records", "time_s", "charge_s",
                 "time_list", "charge_list", "_mean_charge", "_detail",
                 "_space_rows", "_device")

    def __init__(self, results: Mapping[str, CachedResult]):
        self.keys = tuple(results.keys())
        self.index = {k: i for i, k in enumerate(self.keys)}
        self.records = tuple(results.values())
        # Python-float mirrors of the hot columns: small batches (a
        # population generation) resolve faster through plain list indexing
        # than through numpy's per-call overhead; the arrays win for big
        # gathers. Both views hold bit-identical values.
        self.time_list = [r.time_s for r in self.records]
        self.charge_list = [r.charge_s for r in self.records]  # fixed-order
        self.time_s = np.array(self.time_list, dtype=np.float64)
        self.charge_s = np.array(self.charge_list, dtype=np.float64)
        self._mean_charge: float | None = None
        # compile/run-split detail columns are built on first access — the
        # replay/scoring hot paths never touch them, and every insert
        # invalidation triggers a rebuild of this object
        self._detail: tuple | None = None
        self._space_rows: tuple | None = None  # (compiled, row map) memo
        # device-tensor mirror (core.engine_torch.ReplayTables), never pickled
        self._device: tuple | None = None

    def __getstate__(self) -> dict:
        """Columns rarely pickle (``CacheFile`` drops them), but when they
        do, the space-keyed memos stay behind: ``_space_rows`` drags a
        whole ``CompiledSpace`` along and ``_device`` holds device tensors
        that must not cross process boundaries."""
        return {k: getattr(self, k) for k in self.__slots__
                if k not in ("_space_rows", "_device")}

    def __setstate__(self, state: dict) -> None:
        for k, v in state.items():
            setattr(self, k, v)
        self._space_rows = None
        self._device = None

    def __len__(self) -> int:
        return len(self.keys)

    def _detail_columns(self) -> tuple:
        if self._detail is None:
            n = len(self.records)
            compile_s = np.empty(n, dtype=np.float64)
            run_s = np.empty(n, dtype=np.float64)
            overhead_s = np.empty(n, dtype=np.float64)
            ok = np.empty(n, dtype=bool)
            for i, r in enumerate(self.records):
                compile_s[i] = r.compile_s
                run_s[i] = sum(r.times_s)  # scalar fixed-order reduction
                overhead_s[i] = r.overhead_s
                ok[i] = r.status == "ok"
            self._detail = (compile_s, run_s, overhead_s, ok)
        return self._detail

    @property
    def compile_s(self) -> np.ndarray:
        return self._detail_columns()[0]

    @property
    def run_s(self) -> np.ndarray:
        return self._detail_columns()[1]

    @property
    def overhead_s(self) -> np.ndarray:
        return self._detail_columns()[2]

    @property
    def ok(self) -> np.ndarray:
        return self._detail_columns()[3]

    @property
    def mean_charge(self) -> float:
        """Bit-identical to the scalar ``CacheFile.mean_eval_charge`` (a
        Python left-to-right sum over insertion order, not ``np.mean``)."""
        if self._mean_charge is None:
            self._mean_charge = sum(self.charge_list) / len(self.charge_list)
        return self._mean_charge

    def rows_for(self, keys: Sequence[str]) -> np.ndarray:
        """Row indices for a batch of config-id keys; -1 marks keys outside
        the recorded set (the replay treats those as failed compiles)."""
        idx = self.index
        return np.fromiter((idx.get(k, -1) for k in keys),
                           dtype=np.int64, count=len(keys))

    def rows_for_space(self, compiled) -> np.ndarray:
        """Space-row -> cache-row map for a ``core.space.CompiledSpace``:
        the bridge that lets the index-native hot path gather results by
        integer row with no per-evaluation string-id hash probe. Built once
        per (columns, compiled space) pair — config-id strings survive only
        in this one-time boundary translation (and the cache file itself).
        Space rows absent from the recorded set map to -1 (imputed-miss
        semantics, like ``rows_for``)."""
        cached = self._space_rows
        if cached is not None and cached[0] is compiled:
            return cached[1]
        rows = self.rows_for(compiled.ids)
        # plain-list mirror rides along: small-batch commits index it with
        # Python ints (see SimulationRunner._commit_rows_loop), and building
        # it once here keeps short-lived runners (a 25-repeat grid's worth)
        # from each paying an O(n_valid) tolist
        rows.flags.writeable = False
        self._space_rows = (compiled, rows, rows.tolist())
        return rows

    def rows_for_space_list(self, compiled) -> list:
        """The ``rows_for_space`` map as a plain list (same cache entry)."""
        cached = self._space_rows
        if cached is None or cached[0] is not compiled:
            self.rows_for_space(compiled)
            cached = self._space_rows
        return cached[2]


class CacheFile:
    """In-memory view of one brute-forced search space (kernel × device)."""

    def __init__(self, kernel: str, device: str, space: SearchSpace,
                 results: Mapping[str, CachedResult], meta: dict | None = None):
        self.kernel = kernel
        self.device = device
        self.space = space
        self.results = dict(results)
        self.meta = dict(meta or {})
        self._columns: CacheColumns | None = None

    # ------------------------------------------------------------------- api
    def lookup(self, config: Config) -> CachedResult:
        return self.results[self.space.config_id(config)]

    @property
    def columns(self) -> CacheColumns:
        """The columnar view, built lazily and rebuilt after mutation.

        The length guard also catches direct ``results`` dict additions, so
        code that bypasses ``insert`` still never sees stale arrays."""
        cols = self._columns
        if cols is None or len(cols) != len(self.results):
            cols = self._columns = CacheColumns(self.results)
        return cols

    def invalidate_columns(self) -> None:
        """Drop the columnar view; the next ``columns`` access rebuilds it."""
        self._columns = None

    def insert(self, key: str, result: CachedResult,
               overwrite: bool = False) -> None:
        """Add one observation under its ``space.config_id`` key.

        Recorded caches are built incrementally (shards of a live tuning run
        fold in one observation at a time); re-inserting an existing key with
        a different result raises unless ``overwrite`` — silently keeping one
        of two conflicting measurements would corrupt the replay.

        Any columnar view is invalidated: a cache mutated after its arrays
        were built must never serve stale lookups.
        """
        prior = self.results.get(key)
        if prior is not None and prior != result and not overwrite:
            raise ValueError(
                f"cache {self.kernel}@{self.device} already holds a "
                f"different result for config {key!r}")
        self.results[key] = result
        self._columns = None

    def __getstate__(self) -> dict:
        """Pickle without the columnar arrays: parallel campaigns ship caches
        to worker processes once per pool (``parallel.CampaignExecutor``),
        and the view rebuilds lazily on first use — shipping it would roughly
        double the payload for no benefit."""
        state = self.__dict__.copy()
        state["_columns"] = None
        return state

    @property
    def ok_values(self) -> list:
        return [r.time_s for r in self.results.values() if r.status == "ok"]

    @property
    def optimum(self) -> float:
        vals = self.ok_values
        if not vals:
            raise ValueError(
                f"cache {self.kernel}@{self.device} has no successful "
                f"results ({len(self.results)} recorded, all "
                f"{'errors' if self.results else 'missing'}); "
                "a partial recording must cover at least one ok config "
                "before it can be replayed")
        return min(vals)

    def mean_eval_charge(self) -> float:
        """Average simulated cost of one fresh evaluation — used for the
        calculated random-search baseline's time axis. Served from the
        columnar view (the scalar path recomputed the whole sum on every
        out-of-space lookup); the reduction order is unchanged."""
        if not self.results:
            raise ValueError(
                f"cache {self.kernel}@{self.device} is empty (no recorded "
                "evaluations); record or brute-force the space first")
        return self.columns.mean_charge

    # -------------------------------------------------------------------- io
    def to_json(self) -> dict:
        return {
            "format": "T4-mini",
            "format_version": "1.0",
            "kernel": self.kernel,
            "device": self.device,
            "objective": "time_s",
            "tunables": {t.name: list(t.values) for t in self.space.tunables},
            "constraints": [c.description for c in self.space.constraints],
            "meta": self.meta,
            "results": {key: result_to_json(r)
                        for key, r in self.results.items()},
        }

    def save(self, path: str) -> None:
        """Write .json or .json.zst depending on extension; atomic rename."""
        payload = _compress(json.dumps(self.to_json()).encode(), path)
        tmp = path + ".tmp"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)

    @staticmethod
    def load(path: str, space: SearchSpace | None = None) -> "CacheFile":
        with open(path, "rb") as f:
            payload = f.read()
        d = json.loads(_decompress(payload, path))
        if d.get("format") != "T4-mini":
            raise ValueError(f"unknown cache format {d.get('format')!r}")
        if space is None:
            space = membership_space(d["kernel"], d["device"], d["tunables"],
                                     d["results"].keys())
        results = {key: result_from_json(r)
                   for key, r in d["results"].items()}
        return CacheFile(d["kernel"], d["device"], space, results, d.get("meta"))

"""ConfigHub: microsecond best-config lookups over the recorded hub.

``ConfigHub`` reads ``hub/manifest.json`` once into an in-memory index and
answers ``lookup(kernel, problem, device)`` with the best known kernel
configuration:

  * **exact** — the (kernel, device, problem shape) was recorded: after the
    entry's first (lazy, sha256-verified) materialization, the answer is a
    single dict probe of a precomputed best — no disk I/O on the hot path
    (``disk_loads`` counts materializations, so callers can assert that);
  * **transfer** — shape miss: the nearest recorded problem donates its
    best config, with provenance (donor entry, shape distance) and a
    confidence score (``service.transfer``);
  * **warming / warm** — nothing recorded for the kernel at all: with
    ``warm_start=True`` a journaled recording campaign is launched exactly
    once per cold key (single-flight, ``service.warmstart``) and the
    incumbent best is served while results stream in;
  * **modeled** — no measurement worth serving (no donor, or only a donor
    whose transfer confidence falls below
    ``scenarios.surrogate.MODELED_CONFIDENCE``), but the kernel and device
    are modelable: the roofline surrogate's argmin over the valid space
    answers, with fixed confidence ``MODELED_CONFIDENCE`` and ``model``
    provenance. Computed once per (kernel, device, shape), then a dict
    probe;
  * **cold** — nothing recorded, not modelable, no warm-start:
    ``best_config=None``.

Tier order is confidence order: exact (1.0) beats a near-shape transfer
(``1/(1+d)``), which beats modeled (0.3), which beats a far-shape or
cross-device transfer (held as a last resort ahead of cold), which beats
cold (0.0).

Freshness: ``invalidate()`` drops materialized state and re-reads the
manifest (``merge-cache --hub-root`` and warm-start completion route
through ``notify_cache_merged``), and an optional ``ttl_s`` re-stats an
entry's file when its materialization is older than the TTL, re-loading
only if the file actually changed.

Port of ``src/repro/service/hub.py``, a copy with the same tiers, in the
same order, and the same counters, freshness and pickling. Changes: the
storage is the port's (``repro_torch.hub.storage``); a warm-start flight
runs the port's recorder, live on the card for a key that names the
card's label (``service.warmstart``). The card has no device model in
``core/devices.py``, so a key on the card's label that has no recording
never answers ``modeled``: it answers a transfer (from another shape on
the card, or cross-device from a device model's entry), a warm start
when one is enabled, or ``cold``.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
import weakref
from typing import Mapping, Sequence

import numpy as np

from ..hub import storage
from .transfer import donor_order_key, shape_distance, transfer_confidence

# live hubs, by normalized root — merge-cache / warm-start completion push
# invalidations here so long-running services see refreshed recordings
_LIVE_HUBS: "weakref.WeakSet[ConfigHub]" = weakref.WeakSet()


def notify_cache_merged(root: str | None = None, kernel: str | None = None,
                        device: str | None = None) -> int:
    """Invalidate every live ``ConfigHub`` serving ``root`` (all roots when
    None) after a recording was merged/registered. Returns the number of
    hubs notified."""
    root = os.path.abspath(root) if root is not None else None
    n = 0
    for hub in list(_LIVE_HUBS):
        if root is None or os.path.abspath(hub.root) == root:
            hub.invalidate(kernel=kernel, device=device)
            n += 1
    return n


def _modeled_confidence() -> float:
    # lazy: repro.scenarios imports the api facade, which imports this
    # module — only method bodies may cross that boundary
    from ..scenarios.surrogate import MODELED_CONFIDENCE
    return MODELED_CONFIDENCE


@dataclasses.dataclass(frozen=True)
class LookupResult:
    """One service answer, ``TuningRun``-shaped (headline fields + enough
    provenance to audit where the config came from)."""

    kernel: str
    device: str
    problem: dict
    status: str          # exact | transfer | warming | warm | modeled | cold
    best_config: dict | None = None
    best_value: float | None = None  # objective seconds of best_config
    confidence: float = 0.0          # 1.0 exact; see service.transfer
    source: str | None = None        # hub entry key the answer came from
    donor_problem: dict | None = None   # transfer: the donor's shape
    distance: float | None = None       # transfer: shape distance to donor
    n_configs: int = 0               # recorded configs behind the answer
    wall_seconds: float = 0.0
    mode: str = "lookup"
    model: dict | None = None        # modeled: surrogate provenance

    @property
    def found(self) -> bool:
        return self.best_config is not None

    @property
    def tier(self) -> str:
        """The coverage tier this answer belongs to: ``warming``/``warm``
        collapse to ``warm``; every other status is its own tier."""
        return "warm" if self.status in ("warming", "warm") else self.status

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["tier"] = self.tier
        if self.best_value is not None and self.best_value == float("inf"):
            d["best_value"] = None
        return d


class _Entry:
    """One manifest entry in the index: identity + file provenance; the
    expensive parts (cache file, best config) materialize lazily."""

    __slots__ = ("key", "kernel", "device", "pkey", "problem", "path",
                 "sha256", "n_configs", "n_ok")

    def __init__(self, key: str, kernel: str, device: str, pkey: str,
                 problem: dict, entry: Mapping):
        self.key = key
        self.kernel = kernel
        self.device = device
        self.pkey = pkey
        self.problem = problem
        self.path = entry["path"]
        self.sha256 = entry.get("sha256")
        self.n_configs = int(entry.get("n_configs", 0))
        self.n_ok = int(entry.get("n_ok", 0))

    def __getstate__(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}

    def __setstate__(self, state: dict) -> None:
        for k, v in state.items():
            setattr(self, k, v)


class ConfigHub:
    """In-memory lookup service over one hub root. Thread-safe; cheap to
    construct (one manifest read, no cache files touched until a lookup
    needs them). Picklable: workers receive the index and any already-
    computed bests, but never locks, columnar arrays, or warm-start state.
    """

    def __init__(self, root: str = storage.DEFAULT_ROOT, verify: bool = True,
                 ttl_s: float | None = None,
                 warm_start: bool | Mapping = False):
        self.root = root
        self.verify = verify
        self.ttl_s = ttl_s
        self.disk_loads = 0          # materializations (exact hits stay flat)
        self._lock = threading.RLock()
        self._manifest: dict | None = None
        self._index: dict[tuple, _Entry] = {}   # (kernel, device, pkey)
        self._best: dict[tuple, tuple] = {}     # key -> (config, value, n_ok)
        self._materialized: dict[tuple, object] = {}  # key -> CacheColumns
        self._stamp: dict[tuple, tuple] = {}    # key -> (mono, mtime_ns, size)
        self._modeled: dict[tuple, object] = {}  # key -> ModeledBest | None
        self._counters = {"exact": 0, "transfer": 0, "warm": 0,
                          "modeled": 0, "cold": 0}
        self._warm = None
        if warm_start:
            from .warmstart import WarmStartManager
            opts = dict(warm_start) if isinstance(warm_start, Mapping) else {}
            self._warm = WarmStartManager(self, **opts)
        self._reload_index()
        _LIVE_HUBS.add(self)

    # ---------------------------------------------------------------- index
    def _reload_index(self) -> None:
        """(Re)build the in-memory index from the manifest."""
        manifest = storage.read_manifest(self.root)
        index: dict[tuple, _Entry] = {}
        for key, raw in manifest["files"].items():
            kernel, device, pkey = storage.split_key(key)
            problem = dict(
                raw.get("problem")
                or manifest.get("kernels", {}).get(kernel, {}).get("problem")
                or storage.hub_default_problem(kernel))
            if pkey == "":
                # the unsuffixed entry is the kernel's default shape; index
                # it under its *resolved* problem key so passing the default
                # shape explicitly still hits exactly
                pkey = storage.problem_key(problem)
            index[(kernel, device, pkey)] = _Entry(key, kernel, device, pkey,
                                                   problem, raw)
        with self._lock:
            self._manifest = manifest
            self._index = index

    def invalidate(self, kernel: str | None = None,
                   device: str | None = None) -> None:
        """Evict materialized/best state (filtered by kernel/device when
        given) and re-read the manifest, picking up new or re-recorded
        entries."""
        with self._lock:
            def hit(k: tuple) -> bool:
                return ((kernel is None or k[0] == kernel)
                        and (device is None or k[1] == device))
            for store in (self._best, self._materialized, self._stamp,
                          self._modeled):
                for k in [k for k in store if hit(k)]:
                    del store[k]
        self._reload_index()

    # ----------------------------------------------------- materialization
    def _resolve_problem(self, kernel: str, problem: Mapping | None) -> dict:
        """Problem dicts are *overrides* of the kernel's hub-default shape
        (the repo-wide convention, e.g. ``record --problem``): unspecified
        dimensions keep their recorded defaults rather than counting as
        missing in the shape distance."""
        return {**storage.hub_default_problem(kernel), **(problem or {})}

    def _file_sig(self, entry: _Entry) -> tuple | None:
        try:
            st = os.stat(os.path.join(self.root, entry.path))
        except OSError:
            return None
        return (st.st_mtime_ns, st.st_size)

    def _best_for(self, ikey: tuple) -> tuple:
        """(best_config, best_value, n_ok) for an indexed entry; loads and
        verifies the cache file once, then serves from memory (TTL-gated
        re-stat when ``ttl_s`` is set)."""
        with self._lock:
            best = self._best.get(ikey)
            if best is not None:
                if self.ttl_s is None:
                    return best
                stamp = self._stamp.get(ikey)
                if stamp and time.monotonic() - stamp[0] < self.ttl_s:
                    return best
                entry = self._index[ikey]
                sig = self._file_sig(entry)
                if stamp and sig == stamp[1:]:
                    self._stamp[ikey] = (time.monotonic(),) + stamp[1:]
                    return best
                # file changed under us: pick up the refreshed recording
                self._best.pop(ikey, None)
                self._materialized.pop(ikey, None)
                self._reload_index()
            entry = self._index[ikey]
            cache = storage.load_cache(self.root, entry.key, self._manifest,
                                       verify=self.verify)
            self.disk_loads += 1
            cols = cache.columns
            ok = cols.ok
            if ok.any():
                row = int(np.argmin(np.where(ok, cols.time_s, np.inf)))
                cid = cols.keys[row]
                config = cache.space.as_dict(cache.space.config_from_id(cid))
                value = float(cols.time_s[row])
            else:
                config, value = None, None
            best = (config, value, int(ok.sum()))
            self._best[ikey] = best
            self._materialized[ikey] = cols
            sig = self._file_sig(entry)
            self._stamp[ikey] = (time.monotonic(),) + (sig or (0, 0))
            return best

    # ---------------------------------------------------------------- lookup
    def lookup(self, kernel: str, problem: Mapping | None = None,
               device: str = "tpu_v5e") -> LookupResult:
        """Best known config for (kernel, problem shape, device); see the
        module docstring for the exact/transfer/warming/cold semantics."""
        t0 = time.perf_counter()
        target = self._resolve_problem(kernel, problem)
        pkey = storage.problem_key(target)
        ikey = (kernel, device, pkey)
        with self._lock:
            entry = self._index.get(ikey)
        if entry is not None and entry.n_ok > 0:
            config, value, n_ok = self._best_for(ikey)
            if config is not None:
                with self._lock:
                    self._counters["exact"] += 1
                return LookupResult(
                    kernel=kernel, device=device, problem=target,
                    status="exact", best_config=config, best_value=value,
                    confidence=1.0, source=entry.key, n_configs=n_ok,
                    wall_seconds=time.perf_counter() - t0)
        transfer_res = None
        donor = self._nearest_donor(kernel, device, target, exclude=ikey)
        if donor is not None:
            d_entry, dist = donor
            config, value, n_ok = self._best_for(
                (d_entry.kernel, d_entry.device, d_entry.pkey))
            if config is not None:
                cross = d_entry.device != device
                confidence = transfer_confidence(dist, cross)
                transfer_res = LookupResult(
                    kernel=kernel, device=device, problem=target,
                    status="transfer", best_config=config, best_value=value,
                    confidence=confidence,
                    source=d_entry.key, donor_problem=dict(d_entry.problem),
                    distance=dist, n_configs=n_ok,
                    wall_seconds=time.perf_counter() - t0)
                # a near-shape donor outranks the surrogate; a far-shape or
                # cross-device one is held back and only serves if the
                # surrogate can't answer either
                if (confidence >= _modeled_confidence()
                        or not self._modelable(kernel, device)):
                    with self._lock:
                        self._counters["transfer"] += 1
                    return transfer_res
        if transfer_res is None:
            if self._warm is not None and self._warm.can_serve(kernel,
                                                               device):
                result = self._warm.serve(kernel, device, target)
                if result is not None:
                    with self._lock:
                        self._counters["warm"] += 1
                    return dataclasses.replace(
                        result, wall_seconds=time.perf_counter() - t0)
        modeled = self._modeled_best(kernel, device, target)
        if modeled is not None:
            with self._lock:
                self._counters["modeled"] += 1
            return LookupResult(
                kernel=kernel, device=device, problem=target,
                status="modeled", best_config=dict(modeled.config),
                best_value=modeled.value,
                confidence=_modeled_confidence(),
                n_configs=modeled.n_ok, model=modeled.provenance(),
                wall_seconds=time.perf_counter() - t0)
        if transfer_res is not None:
            with self._lock:
                self._counters["transfer"] += 1
            return dataclasses.replace(
                transfer_res, wall_seconds=time.perf_counter() - t0)
        with self._lock:
            self._counters["cold"] += 1
        return LookupResult(kernel=kernel, device=device, problem=target,
                            status="cold",
                            wall_seconds=time.perf_counter() - t0)

    # ---------------------------------------------------------- modeled tier
    @staticmethod
    def _modelable(kernel: str, device: str) -> bool:
        """Can the roofline surrogate answer for this (kernel, device)?"""
        from ..core.devices import DEVICES_BY_NAME
        from ..kernels import KERNELS
        return kernel in KERNELS and device in DEVICES_BY_NAME

    def _modeled_best(self, kernel: str, device: str, target: Mapping):
        """The surrogate argmin for one triple, computed once and then a
        dict probe (``ModeledBest`` is plain data, so it ships to workers
        with the rest of the pickled state)."""
        key = (kernel, device, storage.problem_key(target))
        with self._lock:
            if key in self._modeled:
                return self._modeled[key]
        if not self._modelable(kernel, device):
            best = None
        else:
            from ..scenarios.surrogate import best_modeled
            best = best_modeled(kernel, target, device)
        with self._lock:
            self._modeled[key] = best
        return best

    def _nearest_donor(self, kernel: str, device: str, target: Mapping,
                       exclude: tuple) -> tuple[_Entry, float] | None:
        """Deterministic nearest recorded donor for a shape/device miss."""
        with self._lock:
            candidates = [e for k, e in self._index.items()
                          if e.kernel == kernel and k != exclude
                          and e.n_ok > 0]
        if not candidates:
            return None
        scored = [(donor_order_key(shape_distance(target, e.problem),
                                   e.device != device, e.pkey, e.device), e)
                  for e in candidates]
        order, entry = min(scored, key=lambda t: t[0])
        return entry, order[0]

    def lookup_many(self, requests: Sequence[Mapping]) -> list[LookupResult]:
        """Batched lookups for fleet callers: each request is a mapping with
        ``kernel`` and optional ``problem`` / ``device`` keys. Distinct
        entries materialize once; repeated keys amortize to dict probes."""
        return [self.lookup(r["kernel"], r.get("problem"),
                            r.get("device", "tpu_v5e")) for r in requests]

    # ----------------------------------------------------------------- misc
    def warm_up(self, kernels: Sequence[str] | None = None,
                devices: Sequence[str] | None = None) -> int:
        """Eagerly materialize matching index entries (so a service's first
        real lookups are already O(1)); returns how many were loaded."""
        with self._lock:
            keys = [k for k, e in sorted(self._index.items())
                    if (kernels is None or e.kernel in kernels)
                    and (devices is None or e.device in devices)
                    and e.n_ok > 0]
        n = 0
        for k in keys:
            self._best_for(k)
            n += 1
        return n

    def recorded_keys(self) -> frozenset:
        """The (kernel, device, problem_key) triples backed by a measured
        entry (``n_ok > 0``) — what the scenario matrix classifies as
        ``recorded`` coverage."""
        with self._lock:
            return frozenset(k for k, e in self._index.items() if e.n_ok > 0)

    def stats(self) -> dict:
        with self._lock:
            return {
                "root": self.root,
                "entries": len(self._index),
                "kernels": sorted({e.kernel for e in self._index.values()}),
                "devices": sorted({e.device for e in self._index.values()}),
                "materialized": len(self._best),
                "modeled_cached": len(self._modeled),
                "disk_loads": self.disk_loads,
                "lookups": dict(self._counters),
                "warm_campaigns": (self._warm.launches
                                   if self._warm is not None else 0),
            }

    @property
    def warm_start(self):
        """The ``WarmStartManager`` (None unless enabled)."""
        return self._warm

    # -------------------------------------------------------------- pickling
    def __getstate__(self) -> dict:
        """Ship the index and computed bests to workers, but never locks,
        columnar arrays, warm-start threads, or live-hub registration."""
        state = self.__dict__.copy()
        state["_lock"] = None
        state["_materialized"] = {}
        state["_warm"] = None
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._lock = threading.RLock()

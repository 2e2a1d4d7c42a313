"""``repro_torch.api`` — the public facade over the paper's whole workflow.

One object, four verbs (mirroring the session-style facades of
auto-tuning frameworks like Autotune: heterogeneous machinery behind a
single entry point):

    from repro_torch.api import Tuner

    tuner = Tuner(kernels=("gemm", "hotspot"), devices=("tpu_v5e",),
                  repeats=10, device="cuda")
    run = tuner.simulate("pso")                      # score one config
    run = tuner.hypertune("pso", journal="pso.jsonl")  # Table III campaign
    run = tuner.meta("pso", "simulated_annealing")   # Eq. 4 meta-tuning
    run = tuner.record("ssd", runner="costmodel")    # produce a new cache

Every verb returns a ``TuningRun`` — one result type carrying the mode's
headline numbers (score / best hyperparameters / best kernel config) plus
the full underlying result object for callers that need the details.

Scoring data resolves lazily from either explicit T4 ``caches`` (paths or
``CacheFile`` objects) or a benchmark-hub selection, exactly like the CLI's
``--cache``/``--kernels``/``--devices``/``--split`` options — indeed
``python -m repro_torch`` is a thin argument parser over this class.
Campaign execution (worker pools, JSONL journals with resume, the ask/tell
``SearchDriver`` underneath every strategy run) is wired through
``core.parallel`` / ``core.driver``; see docs/api.md.

Port of ``src/repro/api.py``. Changes: ``Tuner`` takes ``device`` (the
card unless ``"cpu"``), where the scorers' torch engine replays and where
live recordings run, and its ``engine`` defaults to the port's torch
engine; ``Tuner.record`` goes through the port's ``record_cache`` (one
worker for a live recording on the card) and, for a live recording,
labels the cache with the device's name unless ``device`` names a label;
``Hub.build`` takes the port's ``device``, ``kernels`` and ``devices``
(``hub.storage.build_hub``); ``lint`` defaults to the port's package.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Mapping, Sequence

from .core.cache import CacheFile
from .core.hypertuner import (HyperTuningResult, MetaTuningResult,
                              exhaustive_hypertune, hyperparam_searchspace,
                              meta_hypertune, score_hyperconfig)
from .core.methodology import (DEFAULT_CUTOFF, AggregateReport, SpaceScorer,
                               make_scorer)
from .core.parallel import CampaignExecutor, CampaignJournal

__all__ = ["Hub", "Tuner", "TuningRun", "describe_space",
           "hyperparam_space_stats", "lint"]


class Hub:
    """First-class facade over the benchmark hub (the FAIR dataset,
    Sec. III-D) and the lookup service built on it.

        hub = Hub()                       # the bundled hub root
        hub.verify()                      # sha256 every indexed file
        caches = hub.caches(split="train")  # scorer inputs, verified
        hub.lookup("gemm", device="tpu_v5e")  # ConfigHub exact/transfer

    Replaces the retired ``core.dataset`` free functions (which now shim
    here behind ``HubDeprecationWarning``). Storage primitives live in
    ``repro_torch.hub.storage``; the lookup service in
    ``repro_torch.service``.
    """

    def __init__(self, root: str | None = None, verify: bool = True):
        from .hub import storage
        self._storage = storage
        self.root = root or storage.DEFAULT_ROOT
        self.verify_digests = verify
        self._service = None

    @classmethod
    def build(cls, root: str | None = None,
              progress: Callable[[str], None] | None = print, *,
              device: str | None = None,
              kernels: Sequence[str] | None = None,
              devices: Sequence[str] | None = None) -> "Hub":
        """Brute-force the hub spaces into ``root``, record the framework
        kernels' smoke shapes live on ``device`` (the card unless
        ``"cpu"``), and return the facade; ``kernels`` and ``devices``
        narrow the build (``hub.storage.build_hub``)."""
        from .hub import storage
        hub = cls(root)
        storage.build_hub(hub.root, progress, device=device,
                          kernels=kernels, devices=devices)
        return hub

    @property
    def manifest(self) -> dict:
        return self._storage.read_manifest(self.root)

    def verify(self, strict: bool = True) -> dict:
        """sha256-check every indexed file; returns ``{entry: reason}``
        failures (empty = intact). ``strict`` raises ``HubError`` on any."""
        failures = self._storage.verify_manifest(self.root)
        if failures and strict:
            raise self._storage.HubError(
                f"hub at {self.root} failed verification: "
                + "; ".join(f"{k}: {v}" for k, v in sorted(failures.items())))
        return failures

    def load(self, kernels: Sequence[str] | None = None,
             devices: Sequence[str] | None = None) -> dict:
        """``{(kernel, device): CacheFile}`` for the default-shape entries,
        digest-verified per file unless the facade was built with
        ``verify=False``."""
        return self._storage.load_hub(self.root, kernels, devices,
                                      verify=self.verify_digests)

    def caches(self, split: str | None = None,
               kernels: Sequence[str] | None = None,
               devices: Sequence[str] | None = None) -> list[CacheFile]:
        """Cache files as a deterministic list — the scorer-input shape.
        ``split`` ("train"/"test") selects the paper's device split;
        explicit ``devices`` override it."""
        if devices is None and split is not None:
            from .core.devices import TEST_DEVICES, TRAIN_DEVICES
            devices = list(TRAIN_DEVICES if split == "train"
                           else TEST_DEVICES)
        hub = self.load(kernels, devices)
        return [c for _, c in sorted(hub.items())]

    def train_test_caches(self) -> tuple:
        return self._storage.train_test_caches(
            self.root, verify=self.verify_digests)

    def register(self, cache: CacheFile, problem=None) -> str:
        """Save a recorded cache into the hub layout, index it in the
        manifest, and invalidate live lookup services; returns the entry
        key."""
        key = self._storage.register_cache(self.root, cache, problem=problem)
        from .service import notify_cache_merged
        notify_cache_merged(self.root, kernel=cache.kernel)
        return key

    def service(self, ttl_s: float | None = None,
                warm_start: bool | Mapping = False):
        """The ``repro_torch.service.ConfigHub`` over this root (memoized per
        facade; see docs/service.md for lookup semantics)."""
        if self._service is None:
            from .service import ConfigHub
            self._service = ConfigHub(self.root, verify=self.verify_digests,
                                      ttl_s=ttl_s, warm_start=warm_start)
        return self._service

    def lookup(self, kernel: str, problem: Mapping | None = None,
               device: str = "tpu_v5e"):
        """Best known config for (kernel, problem, device) — delegates to
        the memoized service; returns a ``LookupResult``."""
        return self.service().lookup(kernel, problem, device)

    def coverage(self, kernels: Sequence[str] | None = None,
                 devices: Sequence[str] | None = None,
                 with_best: bool = False, device: str | None = None):
        """Scenario-matrix coverage of this hub: every (kernel, shape,
        device) triple classified ``recorded | modeled | cold`` (a
        ``repro_torch.scenarios.CoverageReport``). ``with_best`` resolves
        each answerable triple's best time through the service — the
        payload the CLI report and the fleet regression gate use.
        ``device`` names the live row when ``devices`` is not given (the
        card unless ``"cpu"``)."""
        from .scenarios import ScenarioMatrix
        matrix = ScenarioMatrix(kernels=kernels, devices=devices,
                                device=device)
        return matrix.coverage(self.service(), with_best=with_best)

    def stats(self, device: str | None = None) -> dict:
        """Manifest-level summary (entries, kernels, devices, sizes) plus
        the scenario coverage matrix (its live row ``device``'s label: the
        card unless ``"cpu"``) and live service counters when a service
        has been created."""
        m = self.manifest
        out = {
            "root": self.root,
            "version": m.get("version"),
            "entries": len(m["files"]),
            "kernels": sorted({self._storage.split_key(k)[0]
                               for k in m["files"]}),
            "devices": sorted({self._storage.split_key(k)[1]
                               for k in m["files"]}),
            "n_configs": sum(e.get("n_configs", 0)
                             for e in m["files"].values()),
            "n_ok": sum(e.get("n_ok", 0) for e in m["files"].values()),
            "bruteforce_hours": round(sum(
                sum(v.values()) for v in m.get("bruteforce_hours",
                                               {}).values()), 1),
        }
        report = self.coverage(device=device)
        out["coverage"] = {"counts": report.counts(),
                           "matrix": report.matrix()}
        if self._service is not None:
            out["service"] = self._service.stats()
        return out


def lint(paths: Sequence[str] | None = None,
         baseline: str | None = None):
    """Run parity-lint (the determinism & pickle-safety static analysis,
    ``repro_torch.analysis``) over ``paths`` (default: the
    ``repro_torch`` package) and return its ``LintResult`` — the
    programmatic face of ``python -m repro_torch lint``. ``baseline`` is a
    path to a grandfathered-findings file; see docs/static-analysis.md
    for the rule catalogue."""
    from .analysis import default_rules, lint_paths
    package = os.path.dirname(os.path.abspath(__file__))
    return lint_paths(list(paths) if paths else [package],
                      baseline=baseline, rules=default_rules())


def describe_space(space) -> dict:
    """Compile one ``SearchSpace`` (if not already compiled) and return its
    stats: cartesian vs valid size, valid fraction, neighbor-degree
    distribution per semantics, compile time. The data behind
    ``python -m repro_torch spaces``."""
    return space.compiled.stats()


def hyperparam_space_stats(extended: bool = False) -> list[dict]:
    """``describe_space`` over every registered strategy's hyperparameter
    grid (Table III, or Table IV with ``extended``) — they compile through
    the same ``core.space`` path as kernel spaces."""
    from .core.hypertuner import hyperparam_searchspace
    from .core.strategies import STRATEGIES
    out = []
    for name, cls in sorted(STRATEGIES.items()):
        grid = cls.EXTENDED_SPACE if extended else cls.HYPERPARAM_SPACE
        if not grid:
            continue
        out.append(describe_space(hyperparam_searchspace(name,
                                                         extended=extended)))
    return out


@dataclasses.dataclass
class TuningRun:
    """Unified result of one ``Tuner`` verb.

    ``mode`` says which verb produced it; the headline fields are filled
    when meaningful for that mode and ``None`` otherwise. The full
    mode-specific result object (``AggregateReport``,
    ``HyperTuningResult``, ``MetaTuningResult``, or the recorded
    ``CacheFile``) rides along for detailed consumers.
    """

    mode: str                      # simulate | hypertune | meta | record
    strategy: str
    score: float | None = None             # Eq. 3 aggregate (best, for
    #                                        campaign modes)
    best_hyperparams: dict | None = None   # hypertune / meta
    best_config: dict | None = None        # record: best kernel config
    best_value: float | None = None        # record: its objective seconds
    n_evaluated: int | None = None         # configs / hp-configs evaluated
    wall_seconds: float = 0.0
    simulated_seconds: float = 0.0         # what live tuning would have cost
    report: AggregateReport | None = None          # simulate
    hypertuning: HyperTuningResult | None = None   # hypertune
    meta: MetaTuningResult | None = None           # meta
    cache: CacheFile | None = None                 # record
    cache_path: str | None = None                  # record
    # how the campaign grid was driven: "device" (fused on the torch
    # engine), "host" (interleaved ask/tell), "sequential", or "mixed"
    # (differed per space). Informational — scores are bit-identical
    # across modes. None for modes without a drive (record).
    fuse: str | None = None

    @property
    def speedup(self) -> float | None:
        """Simulated-vs-wall speedup (the paper's Fig. 9 headline ratio)."""
        if not self.simulated_seconds or not self.wall_seconds:
            return None
        return self.simulated_seconds / self.wall_seconds


class Tuner:
    """Facade over simulation-mode scoring, hypertuning campaigns,
    meta-strategies, and cache recording. See the module docstring.

    Construction is cheap; scorers (including their 1000-run virtual
    baselines) and worker pools are built on first use. Use as a context
    manager — or call ``close()`` — to tear down pooled workers.
    """

    def __init__(self,
                 caches: Sequence[CacheFile | str] | None = None,
                 kernels: Sequence[str] | None = None,
                 devices: Sequence[str] | None = None,
                 split: str = "train",
                 hub_root: str | None = None,
                 engine: str = "torch",
                 cutoff: float = DEFAULT_CUTOFF,
                 repeats: int = 25,
                 seed: int = 0,
                 workers: int = 1,
                 backend: str = "auto",
                 progress: Callable[[str], None] | None = None,
                 device: str | None = None):
        self._caches = list(caches) if caches else None
        self._kernels = list(kernels) if kernels else None
        self._hub_devices = list(devices) if devices else None
        self._split = split
        self._hub_root = hub_root
        self.engine = engine
        self.cutoff = cutoff
        self.repeats = repeats
        self.seed = seed
        self.workers = workers
        self.backend = backend
        self.progress = progress
        self.device = device
        self._scorers: list[SpaceScorer] | None = None
        self._executor: CampaignExecutor | None = None
        self._hub: Hub | None = None

    # ----------------------------------------------------------- resources
    @property
    def scorers(self) -> list[SpaceScorer]:
        """The scoring contexts (paper Sec. III-B: one per search space),
        built lazily from the cache/hub selection."""
        if self._scorers is None:
            self._scorers = [make_scorer(c, cutoff=self.cutoff,
                                         engine=self.engine,
                                         device=self.device)
                             for c in self._resolve_caches()]
        return self._scorers

    def _resolve_caches(self) -> list[CacheFile]:
        if self._caches is not None:
            return [c if isinstance(c, CacheFile) else CacheFile.load(c)
                    for c in self._caches]
        caches = self.hub.caches(split=self._split, kernels=self._kernels,
                                 devices=self._hub_devices)
        if not caches:
            raise ValueError("no hub spaces matched the selection")
        return caches

    @property
    def hub(self) -> Hub:
        """The ``Hub`` facade for this tuner's ``hub_root``."""
        if self._hub is None:
            self._hub = Hub(self._hub_root)
        return self._hub

    @property
    def executor(self) -> CampaignExecutor:
        if self._executor is None:
            self._executor = CampaignExecutor(self.workers, self.backend)
        return self._executor

    def space_stats(self) -> list[dict]:
        """``describe_space`` for every search space of this tuner's
        cache/hub selection (compiles the spaces; does *not* build scorers,
        so no 1000-run baselines are paid for a stats listing)."""
        return [describe_space(c.space) for c in self._resolve_caches()]

    def close(self) -> None:
        if self._executor is not None:
            self._executor.shutdown()
            self._executor = None

    def __enter__(self) -> "Tuner":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------------------------------------------- verbs
    def simulate(self, strategy: str,
                 hyperparams: Mapping | None = None) -> TuningRun:
        """Score one strategy configuration with the methodology
        (Sec. III-B, Eqs. 2–3) across this tuner's spaces."""
        report = score_hyperconfig(strategy, dict(hyperparams or {}),
                                   self.scorers, repeats=self.repeats,
                                   seed=self.seed, executor=self.executor)
        return TuningRun(mode="simulate", strategy=strategy,
                         score=report.score, report=report,
                         n_evaluated=1,
                         wall_seconds=report.wall_seconds,
                         simulated_seconds=report.simulated_seconds,
                         fuse=report.fuse)

    def hypertune(self, strategy: str,
                  journal: str | CampaignJournal | None = None) -> TuningRun:
        """Exhaustive hyperparameter-grid campaign (Sec. IV-B, Table III):
        parallel over this tuner's workers, resumable via ``journal``."""
        res = exhaustive_hypertune(strategy, self.scorers,
                                   repeats=self.repeats, seed=self.seed,
                                   progress=self.progress,
                                   executor=self.executor,
                                   journal=_as_journal(journal))
        best = res.best
        # res.wall_seconds is cumulative across journal resumes — the
        # honest denominator for the Fig. 9 speedup claim
        return TuningRun(mode="hypertune", strategy=strategy,
                         score=best.score,
                         best_hyperparams=dict(best.hyperparams),
                         n_evaluated=len(res.results),
                         wall_seconds=res.wall_seconds,
                         simulated_seconds=res.simulated_seconds,
                         hypertuning=res, fuse=best.report.fuse)

    def meta(self, strategy: str, meta_strategy: str = "simulated_annealing",
             extended: bool = True, max_hp_evals: int = 50,
             meta_hyperparams: Mapping | None = None,
             journal: str | CampaignJournal | None = None) -> TuningRun:
        """Meta-strategy hyperparameter optimization (Sec. IV-C, Eq. 4):
        ``meta_strategy`` explores ``strategy``'s hyperparameter space
        (Table IV when ``extended``), journaled — including mid-run
        ``SearchState`` checkpoints — for resume."""
        res = meta_hypertune(strategy, meta_strategy, self.scorers,
                             extended=extended, max_hp_evals=max_hp_evals,
                             repeats=self.repeats, seed=self.seed,
                             meta_hyperparams=meta_hyperparams,
                             progress=self.progress, executor=self.executor,
                             journal=_as_journal(journal))
        return TuningRun(mode="meta", strategy=strategy,
                         score=res.best_score,
                         best_hyperparams=dict(res.best_hyperparams),
                         n_evaluated=len(res.evaluated),
                         wall_seconds=res.wall_seconds,  # resume-cumulative
                         simulated_seconds=res.simulated_seconds,
                         meta=res, fuse=res.fuse)

    def record(self, kernel: str, runner: str = "live",
               device: str | None = None,
               problem: Mapping | None = None,
               strategy: str = "random_search",
               hyperparams: Mapping | None = None,
               repeats: int = 3, max_evals: int | None = 64,
               max_seconds: float | None = None,
               out: str | None = None,
               bruteforce: bool = False) -> TuningRun:
        """Record a registered kernel into a replayable T4 cache
        (Sec. III-C/D): strategy-sampled by default, exhaustive with
        ``bruteforce=True``; sharded across this tuner's workers, shards
        crash-safe and resumable. A ``live`` recording runs the port's
        kernel on this tuner's ``device`` (the card unless ``"cpu"``; one
        worker on the card) and ``device`` here is its label (default: the
        device's name); for ``costmodel``/``surrogate`` it names the
        device model. Returns the merged cache (saved to ``out``) plus the
        best recorded configuration; ``simulated_seconds`` is the recorded
        configs' charge."""
        from .core import record as rec
        from .kernels import get_kernel

        get_kernel(kernel)  # fail fast on unknown kernels
        t0 = time.perf_counter()
        where = {"target": self.device} if runner == "live" else {}
        spec = rec.RecordSpec.create(
            kernel, runner=runner, device=device, **where,
            problem=dict(problem or {}), strategy=strategy,
            hyperparams=dict(hyperparams or {}), repeats=repeats,
            max_evals=max_evals, max_seconds=max_seconds, seed=self.seed)
        out = out or os.path.join("recorded",
                                  f"{kernel}@{spec.device}.json.gz")
        cache = rec.record_cache(spec, out, workers=self.workers,
                                 bruteforce=bruteforce,
                                 progress=self.progress)
        best_cfg = best_val = None
        ok = [(r.time_s, k) for k, r in cache.results.items()
              if r.status == "ok"]
        if ok:
            best_val, key = min(ok)
            best_cfg = cache.space.as_dict(cache.space.config_from_id(key))
        return TuningRun(mode="record", strategy=strategy,
                         best_config=best_cfg, best_value=best_val,
                         n_evaluated=len(cache.results),
                         wall_seconds=time.perf_counter() - t0,
                         simulated_seconds=sum(
                             r.charge_s for r in cache.results.values()),
                         cache=cache, cache_path=out)

    def lookup(self, kernel: str, problem: Mapping | None = None,
               device: str = "tpu_v5e"):
        """Best known config for (kernel, problem shape, device) from the
        recorded hub — exact hit, nearest-shape transfer, roofline-modeled
        answer, or cold; returns a ``repro_torch.service.LookupResult``
        (``TuningRun``-shaped: ``mode``, ``best_config``, ``best_value``,
        ``wall_seconds`` plus status/provenance/confidence). See
        docs/service.md."""
        return self.hub.lookup(kernel, problem, device)

    def surrogate(self, kernel: str, problem: Mapping | None = None,
                  device: str = "tpu_v5e", strategy: str | None = None,
                  hyperparams: Mapping | None = None,
                  max_evals: int | None = None,
                  max_seconds: float | None = None) -> TuningRun:
        """Tune a kernel against the roofline surrogate instead of a cache
        or live hardware (docs/scenarios.md) — any (registry kernel,
        device model) pair works, recorded or not.

        With ``strategy=None`` the whole valid space is priced and the
        exact argmin returned (what the hub's ``modeled`` lookup tier
        serves). With a strategy name, that strategy runs against a
        ``SurrogateRunner`` under the given budget — the same ask/tell
        driver path as simulation, just surrogate-priced."""
        from .core.budget import Budget, BudgetExhausted
        from .core.devices import DEVICES_BY_NAME
        from .core.strategies import get_strategy
        from .kernels import get_kernel
        from .scenarios.surrogate import SurrogateRunner, best_modeled

        t0 = time.perf_counter()
        if strategy is None:
            mb = best_modeled(kernel, problem, device)
            if mb is None:
                get_kernel(kernel)  # raise the more precise error
                raise ValueError(
                    f"unknown device model {device!r}; known: "
                    f"{sorted(DEVICES_BY_NAME)}")
            return TuningRun(mode="surrogate", strategy="exhaustive",
                             best_config=dict(mb.config),
                             best_value=mb.value, n_evaluated=mb.n_valid,
                             wall_seconds=time.perf_counter() - t0)
        spec = get_kernel(kernel)
        dev = DEVICES_BY_NAME.get(device)
        if dev is None:
            raise ValueError(f"unknown device model {device!r}; known: "
                             f"{sorted(DEVICES_BY_NAME)}")
        problem = dict(problem or {})
        space = spec.space(problem)
        budget = Budget(max_seconds=max_seconds, max_evals=max_evals or 64)
        runner = SurrogateRunner(space, spec.workload(problem), dev, budget)
        import random
        try:
            get_strategy(strategy, **dict(hyperparams or {})).run(
                space, runner, random.Random(self.seed))
        except BudgetExhausted:
            pass
        best = runner.best
        return TuningRun(
            mode="surrogate", strategy=strategy,
            best_config=(space.as_dict(best.config) if best else None),
            best_value=(best.value if best else None),
            n_evaluated=runner.fresh_evals,
            wall_seconds=time.perf_counter() - t0,
            simulated_seconds=budget.spent_seconds)


def _as_journal(journal: str | CampaignJournal | None
                ) -> CampaignJournal | None:
    if journal is None or isinstance(journal, CampaignJournal):
        return journal
    return CampaignJournal(journal)

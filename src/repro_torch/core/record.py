"""Record → merge → replay: producing FAIR simulation caches from live runs.

The paper's two headline artifacts are a FAIR dataset of recorded tuning
runs (Sec. III-D) and a simulation mode that replays them at two orders of
magnitude lower cost (Sec. III-C). The seed repo could only *consume*
caches; this module closes the loop and *produces* them from any runner:

  * ``ObservationShard`` — an append-only JSONL file of observations, one
    per fresh evaluation, durably fsync'd as it is measured (the
    ``CampaignJournal`` machinery under a ``repro-shard`` format tag). A
    recording killed at any point keeps everything measured so far.
  * ``RecordingRunner`` — wraps any runner (``LiveRunner`` for the port's
    kernels on the card, ``CostModelRunner`` for device models) and
    appends every fresh observation's full ``CachedResult`` to a shard.
    Because the runner protocol already charges exactly
    ``compile + Σ(repeats) + overhead``, a recorded run replays through
    ``SimulationRunner`` with a bit-identical trajectory.
  * ``merge_shards`` — folds the shards of parallel workers into one
    canonical ``CacheFile`` (T4-mini), the unit the simulation mode and the
    hypertuning campaigns consume.

Worker task functions (``record_shard_task``, ``bruteforce_shard_task``)
are module-level and driven by picklable ``RecordSpec`` payloads so a
``CampaignExecutor`` can fan recording out over process pools — each worker
owns one shard file, and the merge step reconciles them afterwards.

Port copy of ``src/repro/core/record.py``
and kept as its own copy: the port imports nothing of ``repro``.
Changes: kernels resolve from the port's registry (``repro_torch.kernels``);
a live ``RecordSpec`` names where its kernel runs (``target``, the card
unless ``"cpu"``) and labels its cache with the card's name; the
``"surrogate"`` runner waits for the scenario slice; and ``record_cache``
(the orchestration the reference keeps in ``repro.api.Tuner.record``)
refuses a live recording on the card with more than one worker.
The shard and cache formats are unchanged, so shards and caches move
freely between the two packages.
"""
from __future__ import annotations

import dataclasses
import os
import random
import zlib
from typing import Callable, Mapping, Sequence

from ..cuda import device_label, resolve_device
from .budget import Budget, BudgetExhausted
from .cache import (CachedResult, CacheFile, membership_space,
                    result_from_json, result_to_json)
from .devices import DEVICES_BY_NAME
from .parallel import CampaignExecutor, CampaignJournal
from .runner import CostModelRunner, LiveRunner, Observation, Runner
from .searchspace import SearchSpace
from .strategies import get_strategy

SHARD_FORMAT = "repro-shard"

# header fields that must agree for shards to describe the same measurement
# campaign: the space itself plus everything that changes what one
# evaluation *means* (problem sizes, repeat count, live vs cost model)
SHARD_IDENTITY = ("kernel", "device", "tunables", "problem", "repeats",
                  "runner")


class ObservationShard:
    """One worker's crash-safe JSONL slice of a recording campaign.

    Line 1 identifies what was measured (kernel, device, tunables, problem
    sizes, runner kind); every further line is one config's ``CachedResult``.
    Appends are flushed + fsync'd (CampaignJournal semantics): a recording
    interrupted mid-measurement loses at most the in-flight config, and a
    torn trailing line is skipped on read.
    """

    def __init__(self, path: str):
        self.path = path
        self._journal = CampaignJournal(path, fmt=SHARD_FORMAT)

    @staticmethod
    def header(kernel: str, device: str, space: SearchSpace,
               **extra) -> dict:
        return {
            "kernel": kernel,
            "device": device,
            "tunables": {t.name: list(t.values) for t in space.tunables},
            "constraints": [c.description for c in space.constraints],
            **extra,
        }

    def ensure_header(self, header: Mapping) -> dict:
        """Create or validate the shard; returns already-recorded results
        keyed by config id (resume support: they pre-seed the runner memo)."""
        records = self._journal.ensure_header(header)
        return {d["id"]: result_from_json(d) for d in records}

    def read(self) -> tuple[dict | None, dict]:
        """Return ``(header, {config_id: CachedResult})``."""
        header, records = self._journal.read()
        results: dict[str, CachedResult] = {}
        for d in records:
            if "id" in d:  # ignore foreign/unknown record shapes
                results[d["id"]] = result_from_json(d)
        return header, results

    def append(self, key: str, result: CachedResult) -> None:
        self._journal.append({"id": key, **result_to_json(result)})


# -------------------------------------------------------------- recording
class RecordingRunner:
    """Transparent recorder around any runner.

    Strategies see the wrapped runner unchanged (memo, budget, trace all
    delegate), but every *fresh* evaluation — the only kind that measures
    anything — is appended to the shard the moment it completes. Memoized
    revisits and budget exhaustion pass through unrecorded.
    """

    def __init__(self, inner: Runner, shard: ObservationShard):
        self.inner = inner
        self.shard = shard
        self.recorded = 0

    def preload(self, results: Mapping[str, CachedResult]) -> None:
        """Seed the wrapped runner's memo with already-recorded observations
        (resuming an interrupted recording: re-visiting them is free and
        re-measures nothing). Unknown config ids are skipped — the space may
        have been narrowed since the shard was written."""
        for key, r in results.items():
            try:
                config = self.inner.space.config_from_id(key)
            except KeyError:
                continue
            self.inner.memo[key] = Observation(config, r.time_s, r.status,
                                               r.charge_s, r)

    def run(self, config) -> Observation:
        key = self.inner.space.config_id(config)
        fresh = key not in self.inner.memo
        obs = self.inner.run(config)
        if fresh:
            self.shard.append(key, obs.result)
            self.recorded += 1
        return obs

    def run_batch(self, configs) -> list:
        """Batch evaluation with recording. Must be defined here (not left to
        ``__getattr__`` delegation): forwarding ``run_batch`` straight to the
        wrapped runner would evaluate configs without appending them to the
        shard — a recording that silently loses every batched strategy's
        observations. Live runs measure one config at a time anyway, so the
        loop *is* the batch; each observation is durably recorded the moment
        it is measured."""
        return [self.run(c) for c in configs]

    def __call__(self, config) -> float:
        return self.run(config).value

    def __getattr__(self, name):
        return getattr(self.inner, name)


# ---------------------------------------------------------------- merging
def merge_shards(paths: Sequence[str], space: SearchSpace | None = None,
                 meta: Mapping | None = None) -> CacheFile:
    """Fold observation shards into one canonical ``CacheFile``.

    Shards must agree on their measurement identity (``SHARD_IDENTITY``:
    kernel, device, tunables, problem sizes, repeats, runner kind) —
    merging measurements of different spaces, workloads, or machines would
    corrupt the replay. Duplicate config ids are resolved by runner kind:

      * **live** runners produce noisy timings, and independently-seeded
        workers legitimately revisit the same config — the observation from
        the lowest (worker, path) wins, deterministically, so the merge is
        idempotent and independent of the order shards are listed in;
      * any other runner is expected to be deterministic — a conflicting
        duplicate means the shards come from different recordings, which is
        an error (identical duplicates still fold away).

    ``space`` defaults to a space reconstructed from the shard header's
    tunables with membership as the validity predicate, exactly like
    ``CacheFile.load``; pass the kernel's real space to keep functional
    constraints for replay.
    """
    if not paths:
        raise ValueError("no shards to merge")
    header0: dict | None = None
    # config id -> ((worker, path) provenance rank, result)
    merged: dict[str, tuple[tuple, CachedResult]] = {}
    n_read = 0
    for path in paths:
        header, results = ObservationShard(path).read()
        if header is None:
            continue  # header never written: an empty, freshly-crashed shard
        identity = {k: header.get(k) for k in SHARD_IDENTITY}
        if header0 is None:
            header0 = dict(header, **identity)
        else:
            prior = {k: header0.get(k) for k in identity}
            if identity != prior:
                diff = {k: (identity[k], prior[k]) for k in identity
                        if identity[k] != prior[k]}
                raise ValueError(
                    f"shard {path} was recorded for a different space or "
                    f"workload: {diff}")
        reconcile = header.get("runner") == "live"
        rank = (header.get("worker", 1 << 30), path)
        for key, r in results.items():
            prior_rank_r = merged.get(key)
            if prior_rank_r is None:
                merged[key] = (rank, r)
            elif prior_rank_r[1] == r:
                # equal duplicate: still adopt the lower rank, so a later
                # conflicting shard resolves identically whatever order the
                # equal copies were listed in
                merged[key] = (min(rank, prior_rank_r[0]), r)
            else:
                if not reconcile:
                    raise ValueError(
                        f"shards disagree on config {key!r} (is {path} from "
                        f"a different recording run?)")
                if rank < prior_rank_r[0]:
                    merged[key] = (rank, r)
        n_read += 1
    if header0 is None:
        raise ValueError(f"none of {list(paths)} contains a recorded shard")
    if space is None:
        space = membership_space(header0["kernel"], header0["device"],
                                 header0["tunables"], merged.keys())
    cache_meta = {
        "recorded": True,
        "runner": header0.get("runner", "unknown"),
        "problem": header0.get("problem", {}),
        "repeats": header0.get("repeats"),
        "n_shards": n_read,
        "n_configs": len(merged),
        "n_ok": sum(1 for _, r in merged.values() if r.status == "ok"),
        **dict(meta or {}),
    }
    cache = CacheFile(header0["kernel"], header0["device"], space, {},
                      cache_meta)
    for key, (_, r) in merged.items():
        cache.insert(key, r)
    return cache


# ------------------------------------------------------- parallel plumbing
@dataclasses.dataclass(frozen=True)
class RecordSpec:
    """Picklable description of one recording campaign: everything a worker
    process needs to rebuild the space and runner from the kernel registry
    and write its shard. ``problem`` overrides the kernel's smoke problem
    sizes; ``device`` selects the cost model's device when
    ``runner == "costmodel"`` and is the cache's label otherwise (``create``
    fills in the card's name, or ``"cpu"``); ``target`` is where a live
    kernel runs."""

    kernel: str
    runner: str = "live"            # "live" (the port's kernel) | "costmodel"
    device: str = ""
    target: str = "cuda"            # live only: "cuda" (the card) | "cpu"
    problem: tuple = ()             # sorted ((key, value), ...)
    strategy: str = "random_search"
    hyperparams: tuple = ()         # sorted ((key, value), ...)
    repeats: int = 3                # observations per fresh live evaluation
    max_evals: int | None = 64      # per-worker fresh-eval budget
    max_seconds: float | None = None
    seed: int = 0

    @staticmethod
    def create(kernel: str, **kw) -> "RecordSpec":
        """Normalize ``problem``/``hyperparams`` and, for a live recording,
        resolve ``target`` (the card unless ``"cpu"``; raises without CUDA)
        and default the label to the device's name."""
        kw["problem"] = tuple(sorted(dict(kw.get("problem") or {}).items()))
        kw["hyperparams"] = tuple(
            sorted(dict(kw.get("hyperparams") or {}).items()))
        if kw.get("runner", "live") == "live":
            kw["target"] = resolve_device(kw.get("target"))
            kw["device"] = kw.get("device") or device_label(kw["target"])
        elif not kw.get("device"):
            raise ValueError("a cost-model recording names its device model")
        return RecordSpec(kernel=kernel, **kw)

    @property
    def problem_dict(self) -> dict:
        return dict(self.problem)

    def kernel_spec(self):
        from ..kernels import get_kernel
        return get_kernel(self.kernel)

    def build(self) -> tuple[SearchSpace, "object"]:
        """Resolve (space, kernel spec) from the registry."""
        spec = self.kernel_spec()
        return spec.space(self.problem_dict), spec

    def make_runner(self, space: SearchSpace, budget: Budget) -> Runner:
        if self.runner == "live":
            spec = self.kernel_spec()
            fn = spec.make_live(self.problem_dict, device=self.target)
            return LiveRunner(space, fn, budget, repeats=self.repeats)
        if self.runner == "costmodel":
            try:
                device = DEVICES_BY_NAME[self.device]
            except KeyError:
                raise ValueError(
                    f"unknown device model {self.device!r}; known: "
                    f"{sorted(DEVICES_BY_NAME)}")
            spec = self.kernel_spec()
            return CostModelRunner(space, spec.workload(self.problem_dict),
                                   device, budget)
        raise ValueError(f"unknown runner kind {self.runner!r}")

    def shard_header(self, space: SearchSpace, worker: int,
                     n_workers: int) -> dict:
        return ObservationShard.header(
            self.kernel, self.device, space, runner=self.runner,
            problem=self.problem_dict, repeats=self.repeats,
            strategy=self.strategy, hyperparams=dict(self.hyperparams),
            seed=self.seed, worker=worker, n_workers=n_workers)


def registry_space(kernel: str, problem: Mapping | None) -> SearchSpace | None:
    """The kernel's real search space (functional constraints intact) for
    the recorded problem sizes, or None for kernels not in the registry —
    merges of foreign shards fall back to the membership space."""
    from ..kernels import get_kernel
    try:
        spec = get_kernel(kernel)
    except KeyError:
        return None
    return spec.space(problem or {})


def shard_path(prefix: str, worker: int) -> str:
    return f"{prefix}.shard-{worker:02d}.jsonl"


def record_shard_task(spec: RecordSpec, worker: int, n_workers: int,
                      prefix: str) -> dict:
    """One worker of a strategy-sampled recording: run the configured
    strategy (seeded per worker, so workers explore different regions)
    against a live/cost-model runner, appending every fresh observation to
    this worker's shard. Returns a summary dict."""
    space, _ = spec.build()
    shard = ObservationShard(shard_path(prefix, worker))
    existing = shard.ensure_header(
        spec.shard_header(space, worker, n_workers))
    budget = Budget(max_seconds=spec.max_seconds, max_evals=spec.max_evals)
    runner = spec.make_runner(space, budget)
    rec = RecordingRunner(runner, shard)
    rec.preload(existing)
    rng = random.Random((spec.seed * 1_000_003 + worker)
                        ^ zlib.crc32(spec.kernel.encode()))
    strategy = get_strategy(spec.strategy, **dict(spec.hyperparams))
    strategy.run(space, rec, rng)
    return {"worker": worker, "path": shard.path, "resumed": len(existing),
            "recorded": rec.recorded,
            "measured_seconds": budget.spent_seconds}


def bruteforce_shard_task(spec: RecordSpec, worker: int, n_workers: int,
                          prefix: str) -> dict:
    """One worker of an exhaustive recording: evaluate the worker's
    round-robin slice of the valid space (``configs[worker::n_workers]``) —
    no strategy, no sampling, every config exactly once."""
    space, _ = spec.build()
    shard = ObservationShard(shard_path(prefix, worker))
    existing = shard.ensure_header(
        spec.shard_header(space, worker, n_workers))
    budget = Budget(max_seconds=spec.max_seconds, max_evals=spec.max_evals)
    runner = spec.make_runner(space, budget)
    rec = RecordingRunner(runner, shard)
    rec.preload(existing)
    try:
        for config in space.valid_configs[worker::n_workers]:
            rec.run(config)
    except BudgetExhausted:
        pass  # partial shards are still mergeable/replayable
    return {"worker": worker, "path": shard.path, "resumed": len(existing),
            "recorded": rec.recorded,
            "measured_seconds": budget.spent_seconds}


def record_cache(spec: RecordSpec, out: str, *, workers: int = 1,
                 bruteforce: bool = False,
                 progress: Callable[[str], None] | None = None) -> CacheFile:
    """Record ``spec`` into the T4 cache ``out``: strategy-sampled, or
    exhaustive with ``bruteforce=True``; one crash-safe, resumable shard
    per worker next to ``out``, merged over the kernel's registry space.

    A live recording on the card takes one worker: concurrent processes
    would time their kernels against each other on the same card."""
    if spec.runner == "live" and spec.target != "cpu" and workers > 1:
        raise ValueError("a live recording on the card takes one worker "
                         f"(got {workers}): concurrent processes would time "
                         "kernels against each other")
    prefix = out
    for ext in (".json.zst", ".json.gz", ".json"):
        if prefix.endswith(ext):
            prefix = prefix[:-len(ext)]
            break
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    n = max(1, workers)
    task = bruteforce_shard_task if bruteforce else record_shard_task
    with CampaignExecutor(workers=n) as executor:
        for _, summary in executor.map(task, [(w, n, prefix)
                                              for w in range(n)],
                                       shared=spec):
            if progress is not None:
                progress(f"worker {summary['worker']}: {summary['recorded']} "
                         f"recorded (+{summary['resumed']} resumed) "
                         f"-> {summary['path']}")
    cache = merge_shards([shard_path(prefix, w) for w in range(n)],
                         space=registry_space(spec.kernel, spec.problem_dict),
                         meta={"mode": "bruteforce" if bruteforce
                               else "record"})
    cache.save(out)
    return cache

"""Tuning the tuner (paper Eq. 4, Sec. III-B/E, IV-B/C/D).

Two modes:

  * ``exhaustive_hypertune`` — enumerate a hyperparameter grid (the paper's
    Table III), score every configuration with the methodology across the
    training search spaces, and rank. This quantifies the impact of
    hyperparameter tuning (paper Sec. IV-B: +94.8 % average).
  * ``meta_hypertune`` — treat the hyperparameter space as an ordinary
    SearchSpace and explore it with any registered strategy ("the same
    optimization strategies that are already included" — Sec. IV-C), enabling
    the extended, non-exhaustive tuning of Table IV (+204.7 %).

The bridge is ``FunctionRunner``: a Runner whose objective is the *negated*
aggregate performance score (strategies minimize), and
``results_to_cache``: exhaustive results repackaged as a synthetic T4 cache
so that meta-strategies can themselves be scored with the methodology
(paper Fig. 6) — the recursion that gives the paper its title.

Campaign execution is delegated to ``core.parallel``: both modes accept a
``CampaignExecutor`` (worker-pool fan-out, bit-identical to serial) and a
``CampaignJournal`` (JSONL checkpointing + resume); see that module and the
``python -m repro_torch hypertune|meta`` CLI.

Port copy of ``src/repro/core/hypertuner.py``
and kept as its own copy: the port imports nothing of ``repro``. The code
is the reference's, unchanged; it runs over the port's scorers, so with
the torch engine (their default) every batch of every simulated tuning run
commits through the budget-scan kernel on the scorer's device. The port
registers the reference's nine strategies, so every grid and meta-strategy
of the reference is here; a scipy-driven meta-strategy (dual annealing)
runs through the driver's thread bridge, with every inner campaign on the
driving thread.
"""
from __future__ import annotations

import base64
import dataclasses
import math
import pickle
import random
import time
from typing import Callable, Mapping, Sequence

from .budget import Budget
from .cache import CachedResult, CacheFile
from .driver import SearchDriver
from .methodology import AggregateReport, SpaceScorer, evaluate_strategy
from .parallel import (CampaignExecutor, CampaignJournal, StrategyFactory,
                       campaign_header, report_from_json, report_to_json,
                       score_hyperconfig_task)
from .runner import Runner
from .searchspace import SearchSpace
from .strategies import STRATEGIES, get_strategy
from .strategies.base import hyperparam_id
from .tunable import Config, tunables_from_dict

# mid-run checkpoints larger than this are skipped (the campaign still
# resumes through its memoized per-evaluation records, just replaying the
# meta-strategy's cheap compute): replay-bridge states grow with the told
# history, and a scipy-driven meta-strategy can ask tens of thousands of
# times per run
MAX_CHECKPOINT_BYTES = 1 << 20


def hyperparam_searchspace(strategy_name: str, extended: bool = False) -> SearchSpace:
    """The strategy's hyperparameter grid as an ordinary ``SearchSpace`` —
    which means it compiles through the same ``core.space`` path as kernel
    spaces: meta-strategies walk hyperparameter neighborhoods as CSR row
    slices and sample/repair through the same move tables (constraint-free
    grids compile to an all-valid bitmap in one vectorized pass)."""
    cls = STRATEGIES[strategy_name]
    grid = cls.EXTENDED_SPACE if extended else cls.HYPERPARAM_SPACE
    if not grid:
        raise ValueError(f"{strategy_name} exposes no hyperparameters")
    return SearchSpace(tunables_from_dict(grid), (),
                       name=f"hp[{strategy_name}{'-ext' if extended else ''}]")


@dataclasses.dataclass
class HyperConfigResult:
    hyperparams: dict
    report: AggregateReport

    @property
    def score(self) -> float:
        return self.report.score


@dataclasses.dataclass
class HyperTuningResult:
    strategy: str
    results: dict                  # hp_id -> HyperConfigResult
    wall_seconds: float
    simulated_seconds: float       # what live tuning would have cost

    def ranked(self) -> list:
        return sorted(self.results.values(), key=lambda r: -r.score)

    @property
    def best(self) -> HyperConfigResult:
        return self.ranked()[0]

    @property
    def worst(self) -> HyperConfigResult:
        return self.ranked()[-1]

    def closest_to_mean(self) -> HyperConfigResult:
        """The paper's 'average' configuration: closest score to the mean."""
        rs = list(self.results.values())
        mean = sum(r.score for r in rs) / len(rs)
        return min(rs, key=lambda r: abs(r.score - mean))

    @property
    def scores(self) -> list:
        return [r.score for r in self.results.values()]


def score_hyperconfig(strategy_name: str, hyperparams: Mapping,
                      scorers: Sequence[SpaceScorer], repeats: int = 25,
                      seed: int = 0, executor: CampaignExecutor | None = None
                      ) -> AggregateReport:
    """Score one hyperparameter configuration with the methodology (Eq. 3).

    ``executor`` optionally fans the (space × repeat) grid out in parallel —
    use it when scoring a *single* configuration; campaign-level callers
    should parallelize over configurations instead (one task per config)."""
    return evaluate_strategy(StrategyFactory.create(strategy_name, hyperparams),
                             scorers, repeats=repeats, seed=seed,
                             executor=executor)


def exhaustive_hypertune(strategy_name: str, scorers: Sequence[SpaceScorer],
                         repeats: int = 25, seed: int = 0,
                         progress: Callable[[str], None] | None = None,
                         executor: CampaignExecutor | None = None,
                         journal: CampaignJournal | None = None
                         ) -> HyperTuningResult:
    """Enumerate and score the full hyperparameter grid (paper Table III).

    ``executor`` fans configurations out over a worker pool; results are
    assembled in grid-enumeration order, so parallel campaigns are
    bit-identical to serial ones (Sec. III-C determinism). ``journal``
    checkpoints every completed configuration to JSONL; an interrupted
    campaign restarted with the same journal resumes where it left off,
    re-scoring nothing."""
    space = hyperparam_searchspace(strategy_name)
    t0 = time.perf_counter()
    hp_list = [space.as_dict(cfg) for cfg in space.valid_configs]
    ids = [hyperparam_id(hp) for hp in hp_list]
    done: dict[str, HyperConfigResult] = {}
    prior_wall = 0.0  # campaign wall already spent before this (resumed) run
    if journal is not None:
        header = campaign_header("exhaustive", strategy_name, scorers,
                                 repeats, seed)
        for rec in journal.ensure_header(header):
            if rec.get("type") == "checkpoint":
                continue
            # journal-compat shim: recompute the id from the stored
            # hyperparams rather than trusting rec["hp_id"], so journals
            # written before hyperparam_id escaped ,/=/% resume cleanly
            done[hyperparam_id(rec["hyperparams"])] = HyperConfigResult(
                rec["hyperparams"], report_from_json(rec["report"]))
            prior_wall = max(prior_wall, rec.get("done_wall", 0.0))
        if done and progress:
            progress(f"resumed {len(done)}/{space.size} configs from "
                     f"{journal.path}")
    pending = [(i, hp) for i, hp in enumerate(hp_list) if ids[i] not in done]
    n_done = len(done)
    executor = executor or CampaignExecutor()
    tasks = [(strategy_name, hp, repeats, seed) for _, hp in pending]
    for t_idx, report in executor.map(score_hyperconfig_task, tasks,
                                      shared=tuple(scorers)):
        i, hp = pending[t_idx]
        done[ids[i]] = HyperConfigResult(hp, report)
        if journal is not None:
            # done_wall is cumulative across resumes, so wall-clock stays
            # the true campaign cost (fig9's speedup claim depends on it)
            journal.append({"hp_id": ids[i], "hyperparams": hp,
                            "report": report_to_json(report),
                            "done_wall": prior_wall
                            + time.perf_counter() - t0})
        n_done += 1
        if progress:
            progress(f"[{n_done}/{space.size}] {strategy_name} "
                     f"{ids[i]} -> {report.score:+.4f}")
    results = {ids[i]: done[ids[i]] for i in range(len(hp_list))}
    simulated = sum(r.report.simulated_seconds for r in results.values())
    return HyperTuningResult(strategy_name, results,
                             prior_wall + time.perf_counter() - t0, simulated)


# --------------------------------------------------------------------- meta
class FunctionRunner(Runner):
    """Runner over an arbitrary objective; used for the meta level where one
    'evaluation' is a full (simulated) tuning campaign of a hyperparameter
    configuration. The charge is that campaign's simulated tuning cost, so
    meta-traces live on the same simulated-time axis as everything else."""

    def __init__(self, space: SearchSpace, fn: Callable[[Config], tuple],
                 budget: Budget):
        super().__init__(space, budget)
        self.fn = fn

    def _evaluate(self, config: Config) -> tuple:
        value, charge = self.fn(config)
        status = "ok" if math.isfinite(value) else "error"
        return value, status, charge


@dataclasses.dataclass
class MetaTuningResult:
    strategy: str
    meta_strategy: str
    best_hyperparams: dict
    best_score: float
    evaluated: dict                # hp_id -> score
    trace: list                    # FunctionRunner trace (simulated time axis)
    wall_seconds: float
    simulated_seconds: float = 0.0  # what live tuning would have cost
    # drive mode of the inner campaigns ("device"/"host"/"sequential"/
    # "mixed"); None when every evaluation was journal-memoized
    fuse: str | None = None


def meta_hypertune(strategy_name: str, meta_strategy_name: str,
                   scorers: Sequence[SpaceScorer], extended: bool = True,
                   max_hp_evals: int = 50, repeats: int = 25, seed: int = 0,
                   meta_hyperparams: Mapping | None = None,
                   progress: Callable[[str], None] | None = None,
                   executor: CampaignExecutor | None = None,
                   journal: CampaignJournal | None = None
                   ) -> MetaTuningResult:
    """Optimize hyperparameters with a strategy as the meta-strategy (Eq. 4).

    The meta-level is inherently sequential (each proposal depends on the
    previous observation), so ``executor`` parallelizes *within* one
    hyperparameter evaluation (the methodology's space × repeat grid).

    ``journal`` makes the campaign resumable at two granularities. Every
    completed hyperparameter evaluation is memoized (the objective is
    deterministic given ``(hyperparams, repeats, seed)``), and after each
    one the meta-strategy's ``SearchState`` + runner state are checkpointed
    as a pickled snapshot record. A resumed campaign restores the latest
    snapshot and continues *inside* the tuning run — no meta-strategy
    replay at all; if no usable snapshot exists (old journal, or the
    replay log outgrew ``MAX_CHECKPOINT_BYTES``), it falls back to
    replaying the meta-strategy's cheap compute against the memoized
    evaluations, recomputing nothing either way (paper Sec. IV-C)."""
    space = hyperparam_searchspace(strategy_name, extended=extended)
    evaluated: dict[str, float] = {}
    memo: dict[str, tuple[float, float]] = {}
    prior_wall = 0.0  # campaign wall already spent before this (resumed) run
    snapshot_b64: str | None = None
    if journal is not None:
        header = campaign_header("meta", strategy_name, scorers, repeats,
                                 seed, meta_strategy=meta_strategy_name,
                                 extended=extended,
                                 max_hp_evals=max_hp_evals,
                                 **({"meta_hyperparams":
                                     [[k, v] for k, v in
                                      sorted(meta_hyperparams.items())]}
                                    if meta_hyperparams else {}))
        for rec in journal.ensure_header(header):
            if rec.get("type") == "checkpoint":
                snapshot_b64 = rec["snapshot"]
                continue
            # journal-compat shim: ids recomputed from the stored dict (see
            # exhaustive_hypertune)
            memo[hyperparam_id(rec["hyperparams"])] = (
                rec["score"], rec["simulated_seconds"])
            prior_wall = max(prior_wall, rec.get("done_wall", 0.0))
        if memo and progress:
            progress(f"resumed {len(memo)} evaluations from {journal.path}"
                     + (" (with mid-run state snapshot)"
                        if snapshot_b64 else ""))
    t0 = time.perf_counter()
    fuse_modes: set = set()

    def objective(cfg: Config) -> tuple:
        hp = space.as_dict(cfg)
        hp_id = hyperparam_id(hp)
        if hp_id in memo:
            score, simulated = memo[hp_id]
        else:
            report = score_hyperconfig(strategy_name, hp, scorers, repeats,
                                       seed, executor=executor)
            score, simulated = report.score, report.simulated_seconds
            fuse_modes.add(report.fuse)
            memo[hp_id] = (score, simulated)
            if journal is not None:
                journal.append({"hp_id": hp_id, "hyperparams": hp,
                                "score": score,
                                "simulated_seconds": simulated,
                                "done_wall": prior_wall
                                + time.perf_counter() - t0})
        evaluated[hp_id] = score
        if progress:
            progress(f"meta[{meta_strategy_name}] {strategy_name} "
                     f"{hp_id} -> {score:+.4f}")
        # minimize negated score; charge the simulated cost of the campaign
        return -score, simulated

    runner = FunctionRunner(space, objective, Budget(max_evals=max_hp_evals))
    meta = get_strategy(meta_strategy_name, **(meta_hyperparams or {}))
    if snapshot_b64 is not None:
        snap = pickle.loads(base64.b64decode(snapshot_b64))
        evaluated.update(snap.get("evaluated", {}))
        driver = SearchDriver.resume(meta, space, runner, snap)
    else:
        driver = SearchDriver(meta, space, runner, random.Random(seed))

    last_fresh = runner.fresh_evals

    def checkpoint(d: SearchDriver) -> None:
        # one snapshot per completed hyperparameter evaluation; generations
        # that only revisit memoized configs advance nothing worth saving
        nonlocal last_fresh
        if journal is None or runner.fresh_evals == last_fresh:
            return
        last_fresh = runner.fresh_evals
        snap = d.snapshot()
        snap["evaluated"] = dict(evaluated)
        payload = pickle.dumps(snap, protocol=pickle.HIGHEST_PROTOCOL)
        if len(payload) > MAX_CHECKPOINT_BYTES:
            return  # resume will fall back to memoized-evaluation replay
        journal.append({"type": "checkpoint", "fresh_evals": last_fresh,
                        "snapshot": base64.b64encode(payload).decode()})

    best = driver.run(checkpoint=checkpoint if journal is not None else None)
    if best is None:
        raise RuntimeError("meta-strategy found no valid hyperparameters")
    return MetaTuningResult(
        strategy_name, meta_strategy_name,
        space.as_dict(best.config), -best.value, evaluated,
        list(runner.trace), prior_wall + time.perf_counter() - t0,
        simulated_seconds=runner.budget.spent_seconds,
        fuse=(fuse_modes.pop() if len(fuse_modes) == 1
              else "mixed" if fuse_modes else None))


# ------------------------------------------------- meta-level methodology
def results_to_cache(result: HyperTuningResult,
                     mean_campaign_seconds: float | None = None) -> CacheFile:
    """Repackage exhaustive hypertuning results as a synthetic T4 cache whose
    objective is the negated score — so meta-strategies can be scored with
    the same methodology (paper Fig. 6). Every 'config' charges the mean
    campaign cost (each hyperparameter evaluation costs about the same)."""
    space = hyperparam_searchspace(result.strategy)
    cs = space.compiled
    n = max(1, len(result.results))
    charge = (mean_campaign_seconds
              if mean_campaign_seconds is not None
              else result.simulated_seconds / n)
    cached = {}
    for hp_id, r in result.results.items():
        # row-native id: one flat-index lookup into the precomputed id
        # table instead of a per-config string join
        row = cs.row_of_config(space.from_dict(r.hyperparams))
        key = (cs.ids[row] if row >= 0
               else space.config_id(space.from_dict(r.hyperparams)))
        # objective = -score (dimensionless); the *charge* (time axis) is the
        # campaign cost, carried entirely by compile_s so that
        # charge_s == campaign seconds exactly.
        cached[key] = CachedResult(status="ok", time_s=-r.score,
                                   times_s=(), compile_s=charge)
    return CacheFile(f"hp_{result.strategy}", "meta", space, cached,
                     meta={"level": "hyperparameter", "strategy": result.strategy})

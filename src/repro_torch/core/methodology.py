"""Performance-score methodology (paper Sec. III-B, Eqs. 2–3).

Implements the community methodology the paper builds on [29]:

  * a *calculated* random-search baseline in the **time domain**: the mean
    best-so-far over a fixed set of virtual random-search runs (sampling
    without replacement, each draw charging that configuration's own
    recorded compile+run time). A draw-count-domain hypergeometric
    expectation is optimistic here because objective value and evaluation
    cost are positively correlated (slow kernels also take longer to
    measure); the time-domain curve is the honest baseline. It is
    deterministic: the virtual runs use a fixed seed.
  * a per-space *budget*: the simulated time at which the baseline reaches
    the cutoff fraction (default 95 %) of the median→optimum distance;
  * per-run performance curves ``P_t`` (Eq. 2) sampled at equidistant
    simulated-time points, averaged over repeats;
  * aggregation across search spaces into one score (Eq. 3): 0 ⇔ baseline,
    1 ⇔ optimum found immediately, negative ⇔ worse than baseline.

Port copy of ``src/repro/core/methodology.py``
and kept as its own copy: the port imports nothing of ``repro``.
Changes: ``engine="torch"`` replaces the reference's ``"jax"`` (every
batch committed through ``core.engine_torch`` on the scorer's ``device``);
``"torch"`` is the default engine, so a scorer replays on the card unless
the caller asks for the CPU (``device="cpu"``) or a host engine
(``"vectorized"``/``"scalar"``, the parity oracle); the device-fused drive
(``run_repeats_device``) is not ported yet, so ``drive="device"`` raises
``NotImplementedError`` and ``drive="auto"`` fuses on the host for every
engine. ``run_repeats_fused`` drives ask/tell strategies only (the port's
registry holds no other kind), so the reference's sequential fallbacks for
duck-typed and thread-bridged strategies are left out.
"""
from __future__ import annotations

import dataclasses
import math
import random
import time
import zlib
from typing import Callable, Sequence

import numpy as np

from ..cuda import resolve_device
from .budget import Budget
from .cache import CacheFile
from .runner import SimulationRunner
from .strategies.base import Strategy

DEFAULT_CUTOFF = 0.95
DEFAULT_SAMPLES = 50
BASELINE_RUNS = 1000
BASELINE_SEED = 0xB0B
HARD_TIME_CAP_EVALS = 3000  # tractability cap: budget ≤ cap × mean_charge
ENGINES = ("vectorized", "scalar", "torch")
# Baseline vectorization: batching virtual runs into (block, |space|)
# matrices beats the per-run loop only while the block's working set stays
# cache-resident — for large spaces the per-run arrays already amortize the
# numpy call overhead and batching just burns memory bandwidth (measured:
# 1.7× at 256 configs, 0.8× at 10k). Above the cutover the vectorized
# builder delegates to the per-run path (bit-identical either way).
_BASELINE_VECTOR_MAX_N = 1536
_BASELINE_BLOCK_ELEMS = 1 << 14


@dataclasses.dataclass
class SpaceScorer:
    """Precomputed scoring context for one search space (one cache file).

    ``engine`` selects between the ``"torch"`` replay path (the default:
    row resolution through the budget-scan kernel on ``device``; scoring
    and baselines are the vectorized numpy code), the array-backed host
    path (``"vectorized"``: batched baseline construction,
    ``np.searchsorted`` curve sampling, columnar ``SimulationRunner``) and
    the original per-evaluation ``"scalar"`` path. All three produce
    bit-identical scores — the host paths are kept as the parity
    reference, not as a fallback (see ``core.engine_torch`` for the parity
    contract).
    """

    cache: CacheFile
    values: np.ndarray        # sorted finite objective values (ascending)
    n_total: int              # |space| incl. runtime failures
    mean_charge: float        # simulated seconds per fresh evaluation
    optimum: float
    median: float
    budget_s: float
    n_budget: int             # ≈ budget_s / mean_charge (informational)
    # virtual random-search runs: improvement step functions
    _imp_times: np.ndarray    # (R, K) padded with +inf
    _imp_values: np.ndarray   # (R, K) padded with worst value
    engine: str = "torch"
    device: "str | None" = None  # where the torch engine replays

    @property
    def name(self) -> str:
        return f"{self.cache.kernel}@{self.cache.device}"

    # ----------------------------------------------------------- baseline
    def baseline_at_time(self, t) -> np.ndarray:
        """S_baseline(t): mean best-so-far of the virtual runs at time(s) t.

        Runs with no finite observation by t impute the worst finite value.
        """
        t_arr = np.atleast_1d(np.asarray(t, dtype=np.float64))
        # count improvements with time <= t per run: (R, T)
        counts = (self._imp_times[:, :, None] <= t_arr[None, None, :]).sum(axis=1)
        idx = np.maximum(counts - 1, 0)
        vals = np.take_along_axis(self._imp_values, idx, axis=1)
        vals = np.where(counts > 0, vals, self.values[-1])
        out = vals.mean(axis=0)
        return out if np.ndim(t) else float(out[0])

    # ------------------------------------------------------------- scoring
    def sample_times(self, n_samples: int = DEFAULT_SAMPLES) -> np.ndarray:
        return np.linspace(self.budget_s / n_samples, self.budget_s, n_samples)

    def score_trace(self, trace: Sequence[tuple], times: np.ndarray,
                    baseline: np.ndarray | None = None) -> np.ndarray:
        """P_t (Eq. 2) for one run's trace [(cum_seconds, value, config)...].

        Before the first finite observation the run scores 0 (== baseline).
        Vectorized: the best-so-far step function comes from
        ``np.minimum.accumulate`` over the trace's value column, and all
        sample points resolve through one ``np.searchsorted`` over the
        improvement times — bit-identical to the scalar loop (same float64
        arithmetic per sample).
        """
        if self.engine == "scalar":
            return self._score_trace_scalar(trace, times, baseline)
        # improvement extraction stays a single sequential pass (a handful
        # of appends; vectorizing it would re-read every trace tuple into
        # arrays and lose on long traces) — the per-sample loop is what
        # vectorizes, collapsing 50 searchsorted calls into one
        best = math.inf
        ts_list, bs_list = [], []
        for t_cum, value, _cfg in trace:
            if value < best:
                best = value
                ts_list.append(t_cum)
                bs_list.append(best)
        return self.score_improvements(
            np.asarray(ts_list, dtype=np.float64),
            np.asarray(bs_list, dtype=np.float64), times, baseline)

    def score_improvements(self, ts: np.ndarray, bs: np.ndarray,
                           times: np.ndarray,
                           baseline: np.ndarray | None = None) -> np.ndarray:
        """``score_trace`` for a run already reduced to its improvement
        step function ``(ts, bs)`` — the form the device-fused campaign
        path hands over (``FusedRun.improvements``), skipping the Python
        trace entirely. Same float64 arithmetic per sample as
        ``score_trace``; the two agree bit-for-bit on every trace."""
        if baseline is None:
            baseline = self.baseline_at_time(times)
        out = np.zeros(len(times))
        if not len(ts):
            return out
        k = np.searchsorted(ts, times, side="right") - 1
        bk = bs[np.maximum(k, 0)]
        sb = np.asarray(baseline, dtype=np.float64)
        denom = sb - self.optimum
        with np.errstate(divide="ignore", invalid="ignore"):
            score = (sb - bk) / denom
        score = np.where(denom <= 0,
                         np.where(bk <= self.optimum, 1.0, 0.0), score)
        valid = (k >= 0) & np.isfinite(bk)
        return np.where(valid, score, 0.0)

    def _score_trace_scalar(self, trace: Sequence[tuple], times: np.ndarray,
                            baseline: np.ndarray | None = None) -> np.ndarray:
        """The original per-sample loop — parity reference for
        ``score_trace`` (kept verbatim; see tests/test_engine_parity.py)."""
        if baseline is None:
            baseline = self.baseline_at_time(times)
        best = math.inf
        ts, bs = [], []
        for t_cum, value, _cfg in trace:
            if value < best:
                best = value
                ts.append(t_cum)
                bs.append(best)
        out = np.zeros(len(times))
        for j, t in enumerate(times):
            k = np.searchsorted(ts, t, side="right") - 1
            if k < 0 or not math.isfinite(bs[k]):
                out[j] = 0.0
                continue
            sb = baseline[j]
            denom = sb - self.optimum
            if denom <= 0:
                out[j] = 1.0 if bs[k] <= self.optimum else 0.0
            else:
                out[j] = (sb - bs[k]) / denom
        return out


def _virtual_random_runs(values: np.ndarray, charges: np.ndarray,
                         n_runs: int, seed: int) -> tuple:
    """Improvement step functions of ``n_runs`` virtual random-search runs
    (without replacement, per-config charges). Returns padded (times, bests).

    Vectorized: runs are processed in blocks as one (block, |space|)
    cumulative-time / running-min computation. Only the permutation *draws*
    stay a loop — ``rng.permutation`` must be called once per run in the
    original order so the RNG stream (and therefore every baseline, budget,
    and downstream score) is bit-identical to the scalar path.
    """
    if len(values) > _BASELINE_VECTOR_MAX_N:
        return _virtual_random_runs_scalar(values, charges, n_runs, seed)
    rng = np.random.default_rng(seed)
    n = len(values)
    block = max(16, _BASELINE_BLOCK_ELEMS // max(n, 1))
    finite = np.isfinite(values)
    worst = values[finite].max()
    blocks: list[tuple[np.ndarray, np.ndarray]] = []
    for start in range(0, n_runs, block):
        r = min(block, n_runs - start)
        perms = np.empty((r, n), dtype=np.intp)
        for i in range(r):
            perms[i] = rng.permutation(n)  # same draw order as scalar
        v = values[perms]                                      # (r, n)
        t = np.cumsum(charges[perms], axis=1)                  # sequential
        run_min = np.fmin.accumulate(
            np.where(np.isfinite(v), v, np.inf), axis=1)
        # improvement points: first occurrence of each new minimum
        is_imp = np.empty((r, n), dtype=bool)
        is_imp[:, 0] = True
        is_imp[:, 1:] = run_min[:, 1:] < run_min[:, :-1]
        is_imp &= np.isfinite(run_min)
        k = int(is_imp.sum(axis=1).max())
        times = np.full((r, k), np.inf)
        bests = np.full((r, k), worst)
        rows, src = np.nonzero(is_imp)
        dest = (np.cumsum(is_imp, axis=1) - 1)[rows, src]
        times[rows, dest] = t[rows, src]
        bests[rows, dest] = run_min[rows, src]
        blocks.append((times, bests))
    k = max(b.shape[1] for b, _ in blocks)
    all_t = np.full((n_runs, k), np.inf)
    all_b = np.full((n_runs, k), worst)
    row = 0
    for times, bests in blocks:
        r, kc = times.shape
        all_t[row:row + r, :kc] = times
        all_b[row:row + r, :kc] = bests
        row += r
    return all_t, all_b


def _virtual_random_runs_scalar(values: np.ndarray, charges: np.ndarray,
                                n_runs: int, seed: int) -> tuple:
    """The original one-run-at-a-time builder — parity reference for
    ``_virtual_random_runs`` (kept verbatim)."""
    rng = np.random.default_rng(seed)
    n = len(values)
    imp_t: list[np.ndarray] = []
    imp_v: list[np.ndarray] = []
    finite = np.isfinite(values)
    worst = values[finite].max()
    for _ in range(n_runs):
        perm = rng.permutation(n)
        v = values[perm]
        t = np.cumsum(charges[perm])
        run_min = np.fmin.accumulate(np.where(np.isfinite(v), v, np.inf))
        # improvement points: first occurrence of each new minimum
        is_imp = np.ones(n, bool)
        is_imp[1:] = run_min[1:] < run_min[:-1]
        is_imp &= np.isfinite(run_min)
        imp_t.append(t[is_imp])
        imp_v.append(run_min[is_imp])
    k = max(len(a) for a in imp_t)
    times = np.full((n_runs, k), np.inf)
    bests = np.full((n_runs, k), worst)
    for i, (a, b) in enumerate(zip(imp_t, imp_v)):
        times[i, :len(a)] = a
        bests[i, :len(b)] = b
    return times, bests


def make_scorer(cache: CacheFile, cutoff: float = DEFAULT_CUTOFF,
                n_baseline_runs: int = BASELINE_RUNS,
                hard_cap: int = HARD_TIME_CAP_EVALS,
                engine: str = "torch",
                device: "str | None" = None) -> SpaceScorer:
    """Scoring context for one cache. ``device`` is where the torch engine
    replays (the card unless ``"cpu"``: without CUDA it must be given, or
    this raises ``RuntimeError``); the host engines ignore it."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; known: {ENGINES}")
    if engine == "torch":
        device = resolve_device(device)
    if engine != "scalar":
        # columnar view: same contents, same insertion order as the scalar
        # comprehension below, built once and shared with the runners
        cols = cache.columns
        all_values, all_charges = cols.time_s, cols.charge_s
        runs_builder = _virtual_random_runs
    else:
        all_values = np.array([r.time_s for r in cache.results.values()],
                              dtype=np.float64)
        all_charges = np.array([r.charge_s for r in cache.results.values()],
                               dtype=np.float64)
        runs_builder = _virtual_random_runs_scalar
    values = np.sort(all_values[np.isfinite(all_values)])
    if values.size == 0:
        raise ValueError(f"cache {cache.kernel}@{cache.device} has no ok results")
    n_total = len(cache.results)
    mean_charge = float(all_charges.mean())
    optimum = float(values[0])
    median = float(np.median(values))
    seed = BASELINE_SEED ^ zlib.crc32(f"{cache.kernel}@{cache.device}".encode())
    imp_t, imp_v = runs_builder(all_values, all_charges,
                                n_baseline_runs, seed)
    scorer = SpaceScorer(cache, values, n_total, mean_charge, optimum, median,
                         budget_s=0.0, n_budget=0, _imp_times=imp_t,
                         _imp_values=imp_v, engine=engine,
                         device=device if engine == "torch" else None)
    # budget: first time the baseline crosses median - cutoff*(median - opt),
    # by bisection (the baseline is monotone non-increasing in t)
    target = median - cutoff * (median - optimum)
    lo, hi = float(all_charges.min()), float(hard_cap * mean_charge)
    if scorer.baseline_at_time(hi) > target:
        budget = hi  # cap reached; effective cutoff < requested
    else:
        for _ in range(48):
            mid = 0.5 * (lo + hi)
            if scorer.baseline_at_time(mid) <= target:
                hi = mid
            else:
                lo = mid
        budget = hi
    scorer.budget_s = budget
    scorer.n_budget = max(1, int(round(budget / mean_charge)))
    return scorer


@dataclasses.dataclass
class AggregateReport:
    """Result of evaluating one strategy (with fixed hyperparameters)."""

    score: float                       # Eq. 3 aggregate
    curve: np.ndarray                  # mean P_t over spaces (len n_samples)
    per_space: dict                    # name -> mean P_t curve
    per_space_score: dict              # name -> float
    fresh_evals: int = 0
    wall_seconds: float = 0.0
    simulated_seconds: float = 0.0
    # how the in-process grid executed: "host" (interleaved drive_many),
    # "sequential" (one cell at a time), or "mixed" when spaces took
    # different paths. Purely informational — scores are bit-identical
    # across all of them.
    fuse: str = "sequential"


@dataclasses.dataclass
class RepeatResult:
    """One (space, repeat) cell of the evaluation grid — the unit of work a
    ``core.parallel.CampaignExecutor`` can fan out."""

    curve: np.ndarray          # P_t (Eq. 2) sampled at this space's times
    fresh_evals: int
    wall_seconds: float
    simulated_seconds: float


def run_repeat(scorer: SpaceScorer, make_strategy: Callable[[], Strategy],
               repeat: int, seed: int, times: np.ndarray,
               baseline: np.ndarray) -> RepeatResult:
    """Run one repeat of one space (one cell of Eq. 3's average) and score
    its trace per Eq. 2. Self-contained and deterministic: the RNG is seeded
    from ``(seed, repeat, space name)`` with a process-independent hash
    (crc32 — str hash is randomized per interpreter), so cells compute
    bit-identical curves whether executed serially, on a thread pool, or in
    another process (paper Sec. III-C: simulation results are exactly
    reproducible)."""
    rng = _repeat_rng(scorer, repeat, seed)
    runner = SimulationRunner(scorer.cache,
                              Budget(max_seconds=scorer.budget_s),
                              engine=scorer.engine, device=scorer.device)
    strategy = make_strategy()
    strategy.run(scorer.cache.space, runner, rng)
    return RepeatResult(scorer.score_trace(runner.trace, times, baseline),
                        runner.fresh_evals, runner.wall_seconds,
                        runner.budget.spent_seconds)


def _repeat_rng(scorer: SpaceScorer, repeat: int, seed: int) -> random.Random:
    """The (space, repeat) cell's RNG — one definition shared by the
    sequential and fused drive paths so they are bit-identical."""
    return random.Random((seed * 1_000_003 + repeat)
                         ^ zlib.crc32(scorer.name.encode()))


def run_repeats_fused(scorer: SpaceScorer,
                      make_strategy: Callable[[], Strategy],
                      repeats: int, seed: int, times: np.ndarray,
                      baseline: np.ndarray) -> list[RepeatResult]:
    """All of one space's repeats as concurrent, ask-fused tuning runs.

    Builds one ``SearchDriver`` per repeat (same per-cell RNG seeding as
    ``run_repeat``) and interleaves them with ``driver.drive_many``: each
    round's asks resolve as one shared columnar gather instead of
    ``repeats`` separate ``run_batch`` calls. Per-run observable state —
    and therefore every curve and score — is bit-identical to the
    sequential loop; only wall time changes. Per-cell ``wall_seconds`` is
    an even share of the fused wall (runs overlap, so a per-runner clock
    would multiple-count).
    """
    from .driver import SearchDriver, drive_many
    t0 = time.perf_counter()
    drivers = []
    for r in range(repeats):
        runner = SimulationRunner(scorer.cache,
                                  Budget(max_seconds=scorer.budget_s),
                                  engine=scorer.engine, device=scorer.device)
        drivers.append(SearchDriver(make_strategy(), scorer.cache.space,
                                    runner, _repeat_rng(scorer, r, seed)))
    drive_many(drivers)
    wall_share = (time.perf_counter() - t0) / max(1, repeats)
    return [RepeatResult(scorer.score_trace(d.runner.trace, times, baseline),
                         d.runner.fresh_evals, wall_share,
                         d.runner.budget.spent_seconds)
            for d in drivers]


def _repeat_cell(ctx: tuple, si: int, r: int) -> RepeatResult:
    """Executor task: ``ctx`` is the campaign-constant context shipped once
    per worker (see ``CampaignExecutor.map(shared=...)``)."""
    scorers, make_strategy, seed, times, baselines = ctx
    return run_repeat(scorers[si], make_strategy, r, seed, times[si],
                      baselines[si])


def evaluate_strategy(make_strategy: Callable[[], Strategy],
                      scorers: Sequence[SpaceScorer],
                      repeats: int = 25,
                      n_samples: int = DEFAULT_SAMPLES,
                      seed: int = 0,
                      executor=None,
                      drive: str = "auto") -> AggregateReport:
    """Run a strategy ``repeats`` times on every space in simulation mode and
    aggregate performance curves per Eq. 3.

    ``executor``: optional ``core.parallel.CampaignExecutor``; the
    (space × repeat) grid is fanned out and reduced in fixed space-major
    order, so the aggregate is bit-identical to the serial loop.

    ``drive`` selects how the in-process grid executes: ``"fused"``
    drives each space's repeats as interleaved host ask/tell runs with
    cross-run batch fusion (``run_repeats_fused``), ``"sequential"`` runs
    one cell at a time (``run_repeat``), and ``"auto"`` (default) fuses
    in-process grids on the host, whatever the engine (with
    ``engine="torch"`` every fused batch is still committed through the
    budget-scan kernel). ``"device"`` (device-resident fused campaigns)
    is not ported yet and raises ``NotImplementedError``. Scores are
    bit-identical across all of them — the drive only changes wall time;
    the chosen mode is surfaced as ``AggregateReport.fuse``.
    """
    if drive not in ("auto", "device", "fused", "sequential"):
        raise ValueError(f"unknown drive mode {drive!r}")
    if drive == "device":
        raise NotImplementedError("fused device campaigns: later slice")
    names = [s.name for s in scorers]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate space names in scorers: {names}")
    times = [s.sample_times(n_samples) for s in scorers]
    baselines = [s.baseline_at_time(t) for s, t in zip(scorers, times)]
    cells_idx = [(si, r) for si in range(len(scorers)) for r in range(repeats)]
    cells: list[RepeatResult | None] = [None] * len(cells_idx)
    modes: list[str] = []
    if executor is not None and executor.parallel:
        ctx = (tuple(scorers), make_strategy, seed, times, baselines)
        # chunk the (space × repeat) grid: vectorized cells are cheap, so
        # amortize pool IPC while keeping ≥ ~4 chunks per worker in flight.
        # Cells are never journaled individually (checkpointing happens one
        # level up, per hyperparameter configuration), so chunking does not
        # coarsen campaign resume granularity.
        chunksize = max(1, len(cells_idx) // (executor.workers * 4))
        for i, res in executor.map(_repeat_cell, cells_idx, shared=ctx,
                                   chunksize=chunksize):
            cells[i] = res
        modes.append("sequential")
    else:
        for si, scorer in enumerate(scorers):
            if drive != "sequential" and scorer.engine != "scalar":
                res = run_repeats_fused(scorer, make_strategy, repeats, seed,
                                        times[si], baselines[si])
                mode = "host"
            else:
                res = [run_repeat(scorer, make_strategy, r, seed, times[si],
                                  baselines[si]) for r in range(repeats)]
                mode = "sequential"
            cells[si * repeats:(si + 1) * repeats] = res
            modes.append(mode)
    per_space: dict[str, np.ndarray] = {}
    per_space_score: dict[str, float] = {}
    fresh = 0
    wall = 0.0
    simulated = 0.0
    for si, scorer in enumerate(scorers):
        acc = np.zeros(n_samples)
        for r in range(repeats):
            cell = cells[si * repeats + r]
            acc += cell.curve
            fresh += cell.fresh_evals
            wall += cell.wall_seconds
            simulated += cell.simulated_seconds
        curve = acc / repeats
        per_space[scorer.name] = curve
        per_space_score[scorer.name] = float(curve.mean())
    mean_curve = np.mean(np.stack(list(per_space.values())), axis=0)
    fuse = modes[0] if len(set(modes)) == 1 else "mixed"
    return AggregateReport(float(mean_curve.mean()), mean_curve, per_space,
                           per_space_score, fresh, wall, simulated, fuse)

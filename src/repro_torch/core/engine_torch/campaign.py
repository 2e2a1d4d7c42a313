"""Device-fused campaigns: whole tuning runs a budget-scan launch.

Port of ``src/repro/core/engine_jax/campaign.py``, function for function.

A campaign driven through ``ReplayEngine.commit_rows`` pays one
ask -> ``run_batch`` -> tell round trip, and one budget-scan launch at
R = 1, for every generation of every run. This module fuses the
budget-replay-commit leg of all of a group's runs into a few launches of
the same kernel (``csrc/budget_scan.cu``) at R = the group's runs, and
keeps the bit-parity contract of the replay-from-log path.

The split that makes this possible: in simulation mode an observation's
*value* is a pure row lookup (``time_s[col_of_row[row]]``, inf for rows
outside the recorded set), and the array-native strategies (GA, PSO, DE,
random search) read only ``observation.value`` in ``tell``. Their ask/tell
trajectory is therefore *budget-independent*: the same numpy/python RNG
stream unfolds whether or not the budget would have stopped the run. So
the host steps the real strategy code as a **trajectory oracle** against
a value table (no Observation objects, no memo, no budget), while the
device does the budget accounting (the parity-critical left-to-right
float64 walk) for *all* runs of a group in one launch a segment.
Everything the device refuses past the exhaustion point is discarded,
which is exactly what ``BudgetExhausted`` discards in the sequential loop:
exhaustion is monotone (charges are non-negative), so the committed prefix
is identical.

Where draw counts are data-dependent (every strategy outside the
allowlist, empty caches whose imputed-miss error must surface on the
host), ``fuse_reason`` names the reason and the caller drives the run on
the host instead. tests/test_torch_campaign.py holds the committed state
bit for bit against the reference's numpy engine.

Changes from the reference:

  * **Eligibility.** ``fuse_reason`` asks for a ``SimulationRunner`` with
    ``engine == "torch"`` (the port's ``engine`` replaces the reference's
    ``columnar`` flag). There is no "engine unavailable" reason: a runner
    asked for the card without CUDA already raised in ``resolve_device``,
    and on ``device="cpu"`` the same code runs the kernel's plain version.
    Nothing here falls back to the host drive because a build, a launch
    or the device failed; those errors propagate.
  * **The launch.** A segment goes out as one packed call through
    ``ScanBlocks`` (one pinned copy in, one launch at R = the group's
    padded width, one copy out, one synchronisation), not as separate
    tensor uploads. The blocks are one set per device and thread for the
    process (``scan_blocks``), so a group reuses the layouts of the groups
    before it. All runs of a group must share one device.
  * **What a segment holds.** The reference stops collecting as soon as
    the approximate budget is spent. The run then ends only when the
    device refuses a fresh row, so when the budget ran out on a
    generation's last fresh row, or the next asks were revisits, each
    further generation went out as a launch of its own (most of an
    exhaustive GA campaign's launches, each of 16–32 entries). Here the
    segment extends past the spent budget up to the first fresh row the
    device will refuse, and an ask with no fresh row (a revisit-only
    generation) is told its values but not sent to the device, where
    every entry of it would be non-fresh. The trajectory is
    budget-independent and the device still decides every commit, so the
    committed state is unchanged; only launches are fewer and shorter.
  * ``_drive_group`` returns its number of launches; each also counts in
    ``engine_torch.replay.launches`` (on the card).
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..cache import CachedResult
from ..runner import INVALID, Observation, SimulationRunner
from ..space import RowBatch
from .replay import (_NO_MAX_E, _NO_MAX_S, OUT_ORDER, ScanBlocks,
                     _budget_limits, _check_rows, _pad_len,
                     first_occurrence)
from .tables import replay_tables

# strategies whose ask/tell trajectory is host-replayable from values alone:
# tell reads only ``observation.value`` (never status/config/result), and
# retains no observation objects
FUSED_STRATEGIES = frozenset(
    {"random_search", "genetic_algorithm", "pso", "differential_evolution"})
# tell is a literal no-op: skip building the value feed entirely
_TELL_NOOP = frozenset({"random_search"})

# rows collected per run per segment before launching: large enough that
# budget-sized runs complete in one launch, small enough that a run whose
# budget exhausts early does not step its oracle far past the cutoff
SEGMENT_ROWS = 4096

# one ScanBlocks per device for each thread (a CampaignExecutor's threads
# may drive groups at once); host state of this process, never pickled
_local = threading.local()


def scan_blocks(device) -> ScanBlocks:
    """This thread's packed call blocks on ``device``."""
    per_device = getattr(_local, "blocks", None)
    if per_device is None:
        per_device = _local.blocks = {}
    key = torch.device(device)
    blocks = per_device.get(key)
    if blocks is None:
        blocks = per_device[key] = ScanBlocks(key)
    return blocks


class _ValueObs:
    """What the trajectory oracle tells the strategy: the minimal stand-in
    for an ``Observation`` (the fused strategies read only ``value``)."""

    __slots__ = ("value",)

    def __init__(self, value: float):
        self.value = value


def fuse_reason(driver) -> "str | None":
    """Why this driver cannot take the device-fused path (None = eligible).

    The reasons mirror the sequential semantics the fast lane must not
    change: other strategies have data-dependent ask streams, an empty
    cache must raise ``mean_eval_charge``'s error at the exact host point,
    and a GA/PSO/DE run with no budget cap never terminates — the
    sequential path at least surfaces progress while it spins.
    """
    strategy = driver.strategy
    name = getattr(strategy, "name", type(strategy).__name__)
    if name not in FUSED_STRATEGIES:
        return (f"strategy {name!r} is not array-native "
                f"(trajectory not host-replayable from values alone)")
    runner = driver.runner
    if not isinstance(runner, SimulationRunner):
        return f"runner {type(runner).__name__} is not a SimulationRunner"
    if runner.engine != "torch":
        return (f"runner engine is {runner.engine!r}, not 'torch' (the "
                f"host engines are the parity reference)")
    if len(runner.cache.columns) == 0:
        return ("cache is empty: the imputed-miss charge error must "
                "surface on the host")
    budget = runner.budget
    if (budget.max_seconds is None and budget.max_evals is None
            and name != "random_search"):
        return f"unbounded budget: {name} never finishes without a cap"
    return None


class FusedRun:
    """One tuning run's fused execution state: the oracle's optimistic
    bookkeeping plus the device-committed prefix."""

    __slots__ = ("driver", "seen", "spent", "evals", "evals0", "max_s",
                 "max_e", "approx_s", "approx_e", "no_more_asks", "done",
                 "exhausted", "acc_rows", "acc_t", "acc_v", "acc_c")

    def __init__(self, driver):
        runner = driver.runner
        self.driver = driver
        # the oracle's own copy: marked optimistically at ask time, while
        # the runner's row state is only touched by the final commit
        self.seen = runner._row_state()[0].copy()
        budget = runner.budget
        self.spent = budget.spent_seconds   # device-authoritative after
        self.evals = budget.spent_evals     # each segment
        self.evals0 = budget.spent_evals
        self.max_s, self.max_e = _budget_limits(budget)
        # host stop heuristic only — np.add.reduce may differ from the
        # device's left-to-right sum by ULPs, so these never decide
        # exhaustion, only when to stop extending a segment
        self.approx_s = self.spent
        self.approx_e = self.evals
        self.no_more_asks = driver.state.finished
        self.done = driver.state.finished
        self.exhausted = False
        # committed (device-accepted) prefix, appended per segment
        self.acc_rows: list = []
        self.acc_t: list = []
        self.acc_v: list = []
        self.acc_c: list = []

    # ------------------------------------------------------------- results
    @property
    def fresh_evals(self) -> int:
        return self.evals - self.evals0

    def trace(self) -> list:
        """The run's fresh-commit trace as ``(t_cum, value, None)`` tuples
        — ``score_trace`` ignores the config column, so the scores-only
        path never materializes configs or Observations."""
        if not self.acc_rows:
            return []
        t = np.concatenate(self.acc_t).tolist()
        v = np.concatenate(self.acc_v).tolist()
        return [(ti, vi, None) for ti, vi in zip(t, v)]

    def improvements(self) -> tuple:
        """The run's improvement step function ``(times, bests)`` as
        float64 arrays — what ``SpaceScorer.score_improvements`` consumes.

        Bit-identical to scanning ``trace()`` with the sequential
        ``value < best`` loop: ``np.fmin.accumulate`` over the committed
        value column takes the same float64 minima in the same order, and
        an improvement is exactly a strictly-smaller running minimum
        (non-finite values never improve — ``inf < inf`` is False in both
        formulations). Lets scores-only consumers skip the Python trace
        entirely."""
        if not self.acc_rows:
            return (np.empty(0, dtype=np.float64),
                    np.empty(0, dtype=np.float64))
        t = np.concatenate(self.acc_t)
        v = np.concatenate(self.acc_v)
        run_min = np.fmin.accumulate(np.where(np.isfinite(v), v, np.inf))
        imp = np.empty(len(v), dtype=bool)
        imp[0] = np.isfinite(run_min[0])
        imp[1:] = run_min[1:] < run_min[:-1]
        return t[imp], run_min[imp]


def _collect_segment(run: FusedRun, value_of_row: np.ndarray,
                     charge_of_row: np.ndarray) -> tuple:
    """Step the run's trajectory oracle until the segment is full, the
    approximate budget is spent, or the strategy stops asking. Returns the
    flattened ``(rows, fresh)`` stream for the device."""
    driver = run.driver
    strategy, state = driver.strategy, driver.state
    feed_values = strategy.name not in _TELL_NOOP
    parts_r: list = []
    parts_f: list = []
    n = 0
    while not run.no_more_asks:
        batch = strategy.ask(state)
        if not batch:
            run.no_more_asks = True
            break
        if not isinstance(batch, RowBatch):  # pragma: no cover - guarded
            raise TypeError(
                f"{strategy.name} asked {type(batch).__name__}, not a "
                f"RowBatch; fuse_reason should have rejected it")
        rows = np.asarray(batch.rows, dtype=np.int64)
        unseen = ~run.seen[rows]
        charges = ()
        # a revisit-only ask commits nothing and leaves the budget as it
        # was: the device never sees it (its rows would all be non-fresh)
        if unseen.any():
            # large duplicate-free asks (random search's permutation) skip
            # the argsort in first_occurrence: one O(n) bincount proves
            # distinctness; small generation-sized asks stay on the
            # generic path where the argsort is already cheap
            if len(rows) >= 1024 and np.bincount(rows).max(initial=0) <= 1:
                fresh = unseen
            else:
                fresh = first_occurrence(rows) & unseen
            run.seen[rows[fresh]] = True
            parts_r.append(rows)
            parts_f.append(fresh)
            n += len(rows)
            charges = charge_of_row[rows[fresh]]
            run.approx_s += float(np.add.reduce(charges))
            run.approx_e += len(charges)
        if feed_values:
            values = value_of_row[rows].tolist()
            strategy.tell(state, [_ValueObs(v) for v in values])
        if n >= SEGMENT_ROWS:
            break
        # once the budget is spent, the device refuses the next fresh row
        # and the run ends there: extend the segment until it holds that
        # row, so a run does not end on a launch of its own
        if len(charges) and (run.approx_s - charges[-1] >= run.max_s
                             or run.approx_e - 1 >= run.max_e):
            break
    if not parts_r:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=bool)
    return np.concatenate(parts_r), np.concatenate(parts_f)


def _drive_group(runs: "list[FusedRun]", cols, compiled) -> int:
    """Drive one cache group's runs to completion; returns the number of
    budget-scan launches (the whole point: a handful, not ~10^4). On the
    CPU each launch is a call of the kernel's plain version."""
    devices = {run.driver.runner.device for run in runs}
    if len(devices) != 1:
        raise ValueError(f"a fused group's runs lie on {sorted(devices)}; "
                         f"all runs of a group must share one device")
    (device,) = devices
    tables = replay_tables(cols, compiled, device)
    col_map = cols.rows_for_space(compiled)
    safe = np.clip(col_map, 0, None)
    if (col_map < 0).any():
        # non-empty cache (fuse_reason gates empty ones), so this is the
        # same finite value every miss commit would compute lazily
        mean_charge = runs[0].driver.runner.cache.mean_eval_charge()
        value_of_row = np.where(col_map >= 0, cols.time_s[safe], np.inf)
        charge_of_row = np.where(col_map >= 0, cols.charge_s[safe],
                                 mean_charge)
    else:
        mean_charge = 0.0
        value_of_row = cols.time_s[safe]
        charge_of_row = cols.charge_s[safe]
    blocks = scan_blocks(device)
    launches = 0
    active = [r for r in runs if not r.done]
    while active:
        todo: list = []
        for run in active:
            rows, fresh = _collect_segment(run, value_of_row, charge_of_row)
            if len(rows) == 0:
                run.done = True
            else:
                _check_rows(rows, tables.n_valid)
                todo.append((run, rows, fresh))
        if not todo:
            break
        # pad both axes to powers of two so the blocks hold a handful of
        # (runs, length) layouts per campaign, not one per round; padded
        # runs ask nothing (fresh False, no cap)
        length = _pad_len(max(len(rows) for _run, rows, _f in todo))
        width = _pad_len(len(todo))
        inp, out = blocks.call(length, runs=width)
        inp["rows"].fill(0)
        inp["fresh"].fill(False)
        inp["spent0"].fill(0.0)
        inp["evals0"].fill(0)
        inp["max_s"].fill(_NO_MAX_S)
        inp["max_e"].fill(_NO_MAX_E)
        for i, (run, rows, fresh) in enumerate(todo):
            inp["rows"][i, :len(rows)] = rows
            inp["fresh"][i, :len(fresh)] = fresh
            inp["spent0"][i] = run.spent
            inp["evals0"][i] = run.evals
            inp["max_s"][i] = run.max_s
            inp["max_e"][i] = run.max_e
        launches += 1
        blocks.run(length, tables, mean_charge, runs=width)
        accept, t_after, value, charge, spent, evals, exhausted = (
            out[name] for name in OUT_ORDER)
        survivors: list = []
        for i, (run, rows, _fresh) in enumerate(todo):
            n = len(rows)
            acc = np.nonzero(accept[i, :n])[0]
            if len(acc):
                run.acc_rows.append(rows[acc])
                run.acc_t.append(t_after[i, acc])
                run.acc_v.append(value[i, acc])
                run.acc_c.append(charge[i, acc])
            # chained-scan seed: the device's final (spent, evals) feeds
            # the next segment, so the left-to-right addition sequence is
            # one unbroken chain — bit-identical to a single long scan
            run.spent = float(spent[i])
            run.evals = int(evals[i])
            run.approx_s = run.spent
            run.approx_e = run.evals
            if exhausted[i]:
                run.exhausted = True
                run.done = True
            elif run.no_more_asks:
                run.done = True
            else:
                survivors.append(run)
        active = survivors
    return launches


def _commit_run(run: FusedRun) -> None:
    """Materialize the device-accepted prefix into the runner — memo,
    trace, budget, freshness — exactly as the sequential commit paths do
    (mirrors ``ReplayEngine.commit_rows``'s host-side commit), then finish
    the driver the way ``drive_many`` would."""
    driver = run.driver
    runner = driver.runner
    seen, obs_by_row, _col_arr, col_list, cols = runner._row_state()
    if run.acc_rows:
        rows = np.concatenate(run.acc_rows)
        t_col = np.concatenate(run.acc_t).tolist()
        vals = np.concatenate(run.acc_v).tolist()
        chgs = np.concatenate(run.acc_c).tolist()
        seen[rows] = True
        cs = runner.space.compiled
        cfg_tab, id_tab = cs.configs, cs.ids
        rows_l = rows.tolist()
        cfgs = [cfg_tab[r] for r in rows_l]
        records = cols.records
        new_obs = Observation.__new__
        set_dict = object.__setattr__
        memo = runner.memo
        for r, cfg, val, chg in zip(rows_l, cfgs, vals, chgs):
            col = col_list[r]
            if col >= 0:
                rec = records[col]
                status = rec.status
            else:
                rec = CachedResult("error", INVALID, (), chg)
                status = "error"
            obs = new_obs(Observation)
            set_dict(obs, "__dict__",
                     {"config": cfg, "value": val, "status": status,
                      "charge_s": chg, "result": rec})
            obs_by_row[r] = obs
            memo[id_tab[r]] = obs
        runner.trace.extend(zip(t_col, vals, cfgs))
        runner.fresh_evals += len(rows_l)
        runner._rows_memo_len = len(memo)
    budget = runner.budget
    budget.spent_seconds = run.spent
    budget.spent_evals = run.evals
    state = driver.state
    state.finished = True
    driver.exhausted = run.exhausted
    state.close()


def drive_fused(drivers, materialize: bool = True) -> "list[FusedRun]":
    """Drive every driver's campaign through the device-fused path.

    All drivers must be eligible (``fuse_reason(d) is None`` — callers
    partition first; this raises ``ValueError`` otherwise). Runs are
    grouped by (cache columns, compiled space) identity and each group
    resolves as a few budget-scan launches on its runners' device. With
    ``materialize=True`` (the ``drive_many`` contract) each runner's
    observable state — memo, trace, budget, ``fresh_evals`` — commits
    bit-identically to the sequential engines; ``materialize=False``
    skips Observation/memo construction for scores-only callers (the
    methodology reads ``FusedRun.improvements()``/``fresh_evals``/
    ``spent`` instead).
    """
    runs: list[FusedRun] = []
    groups: dict = {}
    for d in drivers:
        reason = fuse_reason(d)
        if reason is not None:
            raise ValueError(
                f"driver is not device-fusable: {reason} "
                f"(partition with fuse_reason first)")
        run = FusedRun(d)
        runs.append(run)
        runner = d.runner
        key = (id(runner.cache.columns), id(runner.space.compiled))
        groups.setdefault(key, (runner.cache.columns, runner.space.compiled,
                                []))[2].append(run)
    for cols, compiled, group in groups.values():
        _drive_group(group, cols, compiled)
    if materialize:
        for run in runs:
            _commit_run(run)
    else:
        for run in runs:
            run.driver.state.finished = True
            run.driver.exhausted = run.exhausted
            run.driver.state.close()
    return runs

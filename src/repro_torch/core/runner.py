"""Runners: how a strategy's config evaluations are satisfied.

Three runners implement the same protocol (paper Fig. 1 / Sec. III-E):

  * ``SimulationRunner`` — the paper's simulation mode. Replays a T4 cache:
    returns the recorded result and charges the *recorded* compile/run times
    to a simulated-time budget. "From the point of view of the optimization
    algorithm, there is no perceivable difference between live tuning and the
    simulation mode."
  * ``CostModelRunner`` — computes results on the fly from the analytical
    cost model (used to brute-force the hub; identical values to the cache
    since the model is deterministic).
  * ``LiveRunner`` — times an actual callable (the port's CUDA kernels on
    the card, or their plain versions on the CPU).

All runners memoize: re-evaluating a config returns the cached observation and
charges nothing (Kernel Tuner cache semantics; see budget.py).

Observations carry their full ``CachedResult`` detail (raw repeats,
compile/run split), so any runner can be wrapped in a
``core.record.RecordingRunner`` to persist a live run as a replayable cache
— and because the charge is always ``result.charge_s``, the replay's
simulated-time axis matches the recording bit-for-bit.

Every fresh evaluation is appended to ``trace`` as
``(cumulative_simulated_seconds, objective_value, config)`` — the methodology
computes best-so-far performance curves from this.

Batch evaluation (the ``BatchRunner`` protocol): every runner answers
``run_batch(configs)`` — bit-identical to calling ``run`` in a loop, same
memoization, budget accounting, trace order, and ``BudgetExhausted`` point.
The base implementation *is* that loop (the scalar reference path);
``SimulationRunner`` overrides it to resolve the whole batch through the
cache's columnar view (``cache.CacheColumns``) in one vectorized gather, so
population strategies can evaluate an entire generation per call.

Index-native batches: strategies ask in ``core.space.RowBatch`` form —
integer rows of the compiled space instead of value tuples. A columnar
``SimulationRunner`` resolves those by pure row indexing (``_run_rows``:
row -> cache column via ``CacheColumns.rows_for_space``, O(1) gathers, no
tuple hashing or string-id probes); every other runner just iterates the
batch and receives ordinary value tuples. Config-id strings and value
tuples materialize only on *fresh* commits — the memo/trace/recording
boundary.

Runners are single-run state (memo, budget, trace) and are NOT shared across
threads: parallel campaigns (``core.parallel``) construct one runner per
(space, repeat) task — see ``methodology.run_repeat``.

Port copy of ``src/repro/core/runner.py``
and kept as its own copy: the port imports nothing of ``repro``. Two
changes: ``SimulationRunner`` takes ``engine="torch"`` (the CUDA budget
scan of ``core.engine_torch``, with no fallback; the default) and a
``device``, and ``engine`` replaces the reference's ``columnar`` flag; and
``LiveRunner`` records only configs the kernel rejects as failures, letting
every other exception propagate.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Protocol, Sequence, runtime_checkable

import numpy as np

from ..cuda import ConfigRejected, resolve_device
from .budget import Budget, BudgetExhausted
from .cache import CacheFile, CachedResult
from .costmodel import KernelWorkload, estimate
from .devices import DeviceModel
from .searchspace import SearchSpace
from .space import RowBatch
from .tunable import Config

INVALID = float("inf")


@dataclasses.dataclass(frozen=True)
class Observation:
    config: Config
    value: float               # objective (mean time_s); inf when failed
    status: str                # "ok" | "error"
    charge_s: float            # simulated seconds charged
    # full T4-style detail (raw repeats, compile/run split) — what a
    # RecordingRunner persists so a live run replays bit-identically
    result: CachedResult | None = None


@runtime_checkable
class BatchRunner(Protocol):
    """Anything a strategy can hand a whole generation of configs to.

    Contract: ``run_batch(configs)`` is observably identical to
    ``[run(c) for c in configs]`` — same evaluation order, same memo
    hits, same budget charges and trace entries, and ``BudgetExhausted``
    raised at exactly the same element (results for earlier elements stay
    committed to memo/trace). Implementations are free to *resolve* the
    batch however they like (``SimulationRunner`` gathers it from columnar
    arrays in one shot) as long as the observable sequence matches.
    """

    def run(self, config: Config) -> Observation: ...

    def run_batch(self, configs: Sequence[Config]) -> list[Observation]: ...


class Runner:
    """Base: memoization, budget accounting, trace recording."""

    def __init__(self, space: SearchSpace, budget: Budget):
        self.space = space
        self.budget = budget
        self.memo: dict[str, Observation] = {}
        self.trace: list[tuple[float, float, Config]] = []
        self.fresh_evals = 0
        self.wall_start = time.perf_counter()
        # row-native mirror of the memo (SimulationRunner fast path);
        # declared here so load_state_dict can invalidate it uniformly
        self._rows_st: tuple | None = None
        self._rows_memo_len = -1

    # subclasses implement this
    def _evaluate(self, config: Config) -> "CachedResult | tuple[float, str, float]":
        """Returns a full ``CachedResult`` (preferred: recordable and
        replayable with exact time accounting) or a bare
        ``(value, status, charge_seconds)`` tuple for objectives with no
        compile/run split (e.g. the meta level's campaign scores)."""
        raise NotImplementedError

    def _evaluate_keyed(self, key: str,
                        config: Config) -> tuple[CachedResult, float, str, float]:
        """``(result, value, status, charge)`` for one fresh evaluation.

        The key (already computed by ``run``/``run_batch`` for memoization)
        is passed down so lookup-style runners need not re-derive it.
        """
        out = self._evaluate(config)
        if isinstance(out, CachedResult):
            return out, out.time_s, out.status, out.charge_s
        value, status, charge = out
        # degenerate detail: the whole charge attributed to compile
        return CachedResult(status, value, (), charge), value, status, charge

    def _commit(self, key: str, config: Config, result: CachedResult,
                value: float, status: str, charge: float) -> Observation:
        """Account one fresh evaluation (budget, memo, trace) — the single
        bookkeeping path shared by ``run`` and ``run_batch``."""
        self.budget.charge(charge)
        self.fresh_evals += 1
        obs = Observation(config, value, status, charge, result)
        self.memo[key] = obs
        self.trace.append((self.budget.spent_seconds, value, config))
        return obs

    def run(self, config: Config) -> Observation:
        key = self.space.config_id(config)
        hit = self.memo.get(key)
        if hit is not None:
            return hit
        self.budget.check()  # raises BudgetExhausted when spent
        return self._commit(key, config, *self._evaluate_keyed(key, config))

    def run_batch(self, configs: Sequence[Config]) -> list[Observation]:
        """Evaluate ``configs`` in order (the scalar reference loop).

        See ``BatchRunner``: subclasses that override this must preserve
        loop-of-``run`` observable behaviour exactly.
        """
        return [self.run(c) for c in configs]

    def __call__(self, config: Config) -> float:
        return self.run(config).value

    # ------------------------------------------------------ suspend / resume
    def state_dict(self) -> dict:
        """Picklable snapshot of the observable run state (memo, trace,
        budget spend, fresh-eval count) — what a ``core.driver`` checkpoint
        persists alongside the strategy's ``SearchState``."""
        return {"memo": dict(self.memo), "trace": list(self.trace),
                "fresh_evals": self.fresh_evals,
                "spent_seconds": self.budget.spent_seconds,
                "spent_evals": self.budget.spent_evals}

    def load_state_dict(self, d: dict) -> None:
        """Restore a ``state_dict`` snapshot onto this (freshly built)
        runner; budget *limits* stay as constructed, only the spend is
        restored."""
        self.memo = dict(d["memo"])
        self.trace = list(d["trace"])
        self.fresh_evals = int(d["fresh_evals"])
        self.budget.spent_seconds = float(d["spent_seconds"])
        self.budget.spent_evals = int(d["spent_evals"])
        # the restored memo is a different dict (possibly of the same
        # length); a length check alone cannot catch that
        self._rows_st = None

    @property
    def best(self) -> Observation | None:
        ok = [o for o in self.memo.values() if o.status == "ok"]
        return min(ok, key=lambda o: o.value) if ok else None

    @property
    def wall_seconds(self) -> float:
        return time.perf_counter() - self.wall_start


class SimulationRunner(Runner):
    """Replays a T4 cache; the engine behind every simulated campaign.

    ``engine`` selects the row-resolution backend, and is the one switch:

      * ``"torch"`` (the default): every batch with a fresh row goes
        through ``core.engine_torch``'s budget-scan kernel on ``device``
        (the card unless ``"cpu"`` is asked for, where the kernel's plain
        version runs). Nothing falls back: without CUDA and without
        ``device="cpu"`` the constructor raises ``RuntimeError``.
      * ``"numpy"`` (alias ``"vectorized"``): the cache's array-backed
        view on the host; single evaluations skip the results-dict hop and
        ``run_batch`` gathers a whole generation in one numpy read.
      * ``"scalar"``: the original per-evaluation dict path.

    The host engines are explicit opt-ins, kept as the parity oracle: all
    three commit bit-identically (the columns are built with the scalar
    path's own fixed-order reductions; tests/test_torch_replay.py holds
    the torch engine to the reference's numpy engine).
    """

    ENGINES = ("numpy", "scalar", "torch")

    def __init__(self, cache: CacheFile, budget: Budget,
                 engine: str = "torch", device: "str | None" = None):
        if engine == "vectorized":
            engine = "numpy"
        if engine not in self.ENGINES:
            raise ValueError(f"unknown engine {engine!r}; "
                             f"expected one of {self.ENGINES}")
        super().__init__(cache.space, budget)
        self.cache = cache
        self.engine = engine
        self.device = resolve_device(device) if engine == "torch" else device
        self._torch_eng: object = None  # lazy ReplayEngine

    @property
    def columnar(self) -> bool:
        """Whether rows resolve through the cache's columnar view (every
        engine but ``"scalar"``)."""
        return self.engine != "scalar"

    def torch_engine(self):
        """The bound ``engine_torch.ReplayEngine`` (built on first use)."""
        eng = self._torch_eng
        if eng is None:
            from .engine_torch import ReplayEngine
            eng = self._torch_eng = ReplayEngine(self)
        return eng

    def __getstate__(self) -> dict:
        """Drop the engine handle: it belongs to this process and is
        rebuilt on first use in the receiving one."""
        return {**self.__dict__, "_torch_eng": None}

    def _evaluate(self, config: Config) -> CachedResult:
        try:
            return self.cache.lookup(config)
        except KeyError:
            # config outside the brute-forced/recorded set: treat as a
            # failed compile costing an average evaluation
            return CachedResult("error", INVALID, (),
                                self.cache.mean_eval_charge())

    def _evaluate_keyed(self, key: str,
                        config: Config) -> tuple[CachedResult, float, str, float]:
        if not self.columnar:
            return super()._evaluate_keyed(key, config)
        cols = self.cache.columns
        row = cols.index.get(key, -1)
        if row < 0:
            # mean_eval_charge (not cols.mean_charge) so an empty cache
            # raises its clear "record the space first" error, not a
            # ZeroDivisionError
            charge = self.cache.mean_eval_charge()
            return CachedResult("error", INVALID, (), charge), \
                INVALID, "error", charge
        result = cols.records[row]
        # result.time_s/status are the authoritative Python scalars; the
        # charge comes from the precomputed column (same value, no re-sum)
        return result, result.time_s, result.status, cols.charge_list[row]

    # ------------------------------------------------------- row-native path
    def _row_state(self) -> tuple:
        """Row-indexed mirrors of the run state for the index-native path:
        ``(seen, obs_by_row, col_of_row, col_list, cols)`` over the
        *space's* valid rows (``space.compiled``). ``col_of_row`` bridges
        space rows to cache-column rows (built once per columns view at the
        string boundary; -1 = not recorded). Rebuilt whenever the memo
        changed outside this path (tracked by length — the memo only grows
        — plus an explicit reset in ``load_state_dict``) or the columnar
        view was invalidated, so mixed scalar/keyed/row usage stays
        coherent."""
        cols = self.cache.columns
        st = self._rows_st
        if (st is None or st[4] is not cols
                or len(self.memo) != self._rows_memo_len):
            cs = self.space.compiled
            seen = np.zeros(cs.n_valid, dtype=bool)
            # a plain list, not an object ndarray: int indexing is ~2x
            # cheaper and it is probed once per evaluation
            obs_by_row: list = [None] * cs.n_valid
            if self.memo:
                # re-seed from the memo (resume, or keyed/scalar calls in
                # between); keys outside the space's rows stay keyed-only
                row_get = cs.id_to_row.get
                for key, obs in self.memo.items():
                    row = row_get(key, -1)
                    if row >= 0:
                        seen[row] = True
                        obs_by_row[row] = obs
            col_of_row = cols.rows_for_space(cs)
            st = (seen, obs_by_row, col_of_row,
                  cols.rows_for_space_list(cs), cols)
            self._rows_st = st
            self._rows_memo_len = len(self.memo)
        return st

    # below this batch size the whole-array commit loses to plain bytecode:
    # numpy's per-call overhead (argsort/cumsum/fancy gathers) outweighs
    # the per-evaluation savings for population- and neighborhood-sized
    # asks (measured crossover ~64, same as the old keyed path)
    ROWS_VECTOR_MIN = 64
    # chunk bounds for oversized row asks (see _run_rows)
    ROWS_CHUNK_MIN = 512
    ROWS_CHUNK_MAX = 4096

    def _run_rows(self, rows) -> "list[Observation] | BudgetExhausted":
        """Resolve a batch of space rows (any int sequence); returns the
        observation list or the ``BudgetExhausted`` the equivalent ``run``
        loop would have raised (committed state identical either way)."""
        n = len(rows)
        if n == 0:
            return []
        if self.engine == "torch":
            # every batch with a fresh row dispatches the budget scan
            # (single rows included — uniform coverage for the parity
            # suite); fully-memoized batches short-circuit inside
            return self.torch_engine().commit_rows(rows)
        if n == 1:
            # the single-move shape (simulated annealing, basin hopping,
            # the thread bridge): skip every batch prologue
            st = self._row_state()
            r = rows[0]
            obs = st[1][r]
            return [obs] if obs is not None else self._commit_row(r, st)
        if n <= 256 and self.memo:
            # revisit fast path: local searches re-ask mostly-seen configs
            # (single moves, whole neighborhoods); a fully memoized batch
            # needs no budget/trace work at all — just the row gather.
            # Fresh runners (empty memo) and huge asks (a whole-space
            # permutation) skip the speculative gather — nothing can hit,
            # or the vectorized commit's zero-fresh path handles it in
            # whole-array ops.
            obs_by_row = self._row_state()[1]
            out = [obs_by_row[r] for r in
                   (rows.tolist() if isinstance(rows, np.ndarray)
                    else rows)]
            if None not in out:
                return out
        if n >= self.ROWS_VECTOR_MIN:
            if n <= self.ROWS_CHUNK_MIN:
                return self._commit_rows_vectorized(rows)
            # geometric chunking, like the keyed path: a strategy may hand
            # over far more rows than the budget allows (random search
            # batches the whole space permutation); whole-array commits on
            # rows past the exhaustion point would be pure waste
            arr = np.asarray(rows, dtype=np.int64)
            out: list[Observation] = []
            start, step = 0, self.ROWS_CHUNK_MIN
            while start < n:
                res = self._commit_rows_vectorized(arr[start:start + step])
                if isinstance(res, BudgetExhausted):
                    return res
                out.extend(res)
                start += step
                step = min(step * 2, self.ROWS_CHUNK_MAX)
            return out
        return self._commit_rows_loop(rows)

    def _commit_row(self, r, st) -> "list[Observation] | BudgetExhausted":
        """Commit one fresh row — the scalar ``run`` commit sequence
        (pre-check, charge, memo, trace) by row index."""
        seen, obs_by_row, _col_arr, col_list, cols = st
        budget = self.budget
        if budget.exhausted:
            try:
                budget.check()  # same exception/message as the scalar path
            except BudgetExhausted as e:
                return e
        col = col_list[r]
        if col >= 0:
            rec = cols.records[col]
            status = rec.status
            value = cols.time_list[col]
            charge = cols.charge_list[col]
        else:
            charge = self.cache.mean_eval_charge()
            rec = CachedResult("error", INVALID, (), charge)
            status, value = "error", INVALID
        budget.spent_seconds += charge
        budget.spent_evals += 1
        self.fresh_evals += 1
        cs = self.space.compiled
        config = cs.configs[r]
        obs = Observation.__new__(Observation)
        object.__setattr__(obs, "__dict__",
                           {"config": config, "value": value,
                            "status": status, "charge_s": charge,
                            "result": rec})
        obs_by_row[r] = obs
        seen[r] = True
        self.memo[cs.ids[r]] = obs
        self._rows_memo_len += 1
        self.trace.append((budget.spent_seconds, value, config))
        return [obs]

    def _commit_rows_loop(self, rows) -> "list[Observation] | BudgetExhausted":
        """Small-batch commit: the tight scalar loop of ``run_batch`` with
        every per-evaluation key computation and hash probe replaced by
        integer row indexing. Strings/value tuples appear only on *fresh*
        commits (memo key, trace entry) — the serialization boundary."""
        seen, obs_by_row, _col_arr, col_list, cols = self._row_state()
        cs = self.space.compiled
        ids, cfgs = cs.ids, cs.configs
        memo = self.memo
        budget = self.budget
        append = self.trace.append
        records = cols.records
        time_list, charge_list = cols.time_list, cols.charge_list
        new_obs = Observation.__new__
        set_dict = object.__setattr__  # frozen dataclass: bypass __setattr__
        # budget accounting mirrored in locals (same left-to-right float
        # accumulation as Budget.charge), synced back even when
        # BudgetExhausted aborts the batch mid-way
        max_s, max_e = budget.max_seconds, budget.max_evals
        spent_s, spent_e = budget.spent_seconds, budget.spent_evals
        fresh = self.fresh_evals
        mean_charge: float | None = None
        out: list[Observation] = []
        out_append = out.append
        result: object = out
        try:
            for r in (rows.tolist() if isinstance(rows, np.ndarray)
                      else rows):
                obs = obs_by_row[r]
                if obs is None:
                    if (max_s is not None and spent_s >= max_s) or \
                       (max_e is not None and spent_e >= max_e):
                        budget.spent_seconds = spent_s
                        budget.spent_evals = spent_e
                        budget.check()  # same exception as the scalar path
                    col = col_list[r]
                    if col >= 0:
                        rec = records[col]
                        status = rec.status
                        value = time_list[col]
                        charge = charge_list[col]
                    else:
                        # valid in the space but not recorded: a failed
                        # compile at the mean charge, like the keyed path
                        if mean_charge is None:
                            mean_charge = self.cache.mean_eval_charge()
                        charge = mean_charge
                        rec = CachedResult("error", INVALID, (), charge)
                        status, value = "error", INVALID
                    spent_s += charge
                    spent_e += 1
                    fresh += 1
                    config = cfgs[r]
                    # frozen-dataclass fast construction: one dict display
                    # replaces per-field object.__setattr__ (identical
                    # instance: __eq__/fields/hash semantics unchanged)
                    obs = new_obs(Observation)
                    set_dict(obs, "__dict__",
                             {"config": config, "value": value,
                              "status": status, "charge_s": charge,
                              "result": rec})
                    obs_by_row[r] = obs
                    seen[r] = True
                    memo[ids[r]] = obs
                    append((spent_s, value, config))
                out_append(obs)
        except BudgetExhausted as e:
            result = e
        finally:
            budget.spent_seconds = spent_s
            budget.spent_evals = spent_e
            self.fresh_evals = fresh
            self._rows_memo_len = len(memo)
        return result

    def _commit_rows_vectorized(self, rows
                                ) -> "list[Observation] | BudgetExhausted":
        """Large-batch commit as whole-array operations: one gather through
        ``col_of_row``, bitmap freshness (within-batch first occurrence x
        already-seen rows), a cumulative-sum budget seeded with the exact
        running spend (the same left-to-right float additions as the scalar
        loop, so exhaustion points and trace times match to the last bit),
        and bulk zip-built trace extension. Only fresh evaluations construct
        Observations in Python; revisits gather from the row-indexed object
        array."""
        rows = np.asarray(rows, dtype=np.int64)
        seen, obs_by_row, col_of_row, _col_list, cols = self._row_state()
        col_rows = col_of_row[rows]
        if col_rows.min() < 0:
            # unrecorded rows take the imputed-miss path of the loop commit
            return self._commit_rows_loop(rows)
        n = len(rows)
        order = np.argsort(rows, kind="stable")
        sorted_rows = rows[order]
        first_sorted = np.empty(n, dtype=bool)
        first_sorted[:1] = True
        first_sorted[1:] = sorted_rows[1:] != sorted_rows[:-1]
        first_occ = np.empty(n, dtype=bool)
        first_occ[order] = first_sorted
        fresh_idx = np.nonzero(first_occ & ~seen[rows])[0]
        n_fresh = len(fresh_idx)
        budget = self.budget
        max_s, max_e = budget.max_seconds, budget.max_evals
        cut = n_fresh
        run_cs = None
        if n_fresh:
            # seeded sequential cumsum: run_cs[j] is bit-identical to the
            # scalar loop's spend after j fresh evaluations
            run_cs = np.empty(n_fresh + 1, dtype=np.float64)
            run_cs[0] = budget.spent_seconds
            run_cs[1:] = cols.charge_s[col_rows[fresh_idx]]
            np.cumsum(run_cs, out=run_cs)
            if max_s is not None:
                # exhaustion raises at the first fresh attempt whose spend-
                # so-far already reaches the cap; run_cs is non-decreasing
                cut = min(cut, int(np.searchsorted(run_cs[:n_fresh], max_s,
                                                   side="left")))
            if max_e is not None:
                cut = min(cut, max(0, max_e - budget.spent_evals))
        exhausted = cut < n_fresh
        if cut:
            acc = fresh_idx[:cut]
            acc_rows = rows[acc]
            acc_cols = col_rows[acc]
            seen[acc_rows] = True
            vals = cols.time_s[acc_cols].tolist()
            chgs = cols.charge_s[acc_cols].tolist()
            cs = self.space.compiled
            cfg_tab, id_tab = cs.configs, cs.ids
            cfgs_acc = [cfg_tab[r] for r in acc_rows.tolist()]
            records = cols.records
            new_obs = Observation.__new__
            set_dict = object.__setattr__
            memo = self.memo
            for r, col, cfg, value, charge in zip(acc_rows.tolist(),
                                                  acc_cols.tolist(),
                                                  cfgs_acc, vals, chgs):
                rec = records[col]
                obs = new_obs(Observation)
                set_dict(obs, "__dict__",
                         {"config": cfg, "value": value,
                          "status": rec.status, "charge_s": charge,
                          "result": rec})
                obs_by_row[r] = obs
                memo[id_tab[r]] = obs
            self.trace.extend(zip(run_cs[1:cut + 1].tolist(), vals, cfgs_acc))
            budget.spent_seconds = float(run_cs[cut])
            budget.spent_evals += cut
            self.fresh_evals += cut
            self._rows_memo_len = len(memo)
        if exhausted:
            try:
                budget.check()  # same exception/message as the scalar path
            except BudgetExhausted as exc:
                return exc
        return [obs_by_row[r] for r in rows.tolist()]

    # gather granularity: a strategy may hand over far more configs than the
    # budget allows (random search batches the whole space permutation);
    # chunks grow geometrically so a budget-capped run wastes at most one
    # small chunk of key work past the exhaustion point, while full-space
    # replays still amortize into large chunks
    BATCH_CHUNK_MIN = 64
    BATCH_CHUNK_MAX = 2048

    def run_batch(self, configs: Sequence[Config]) -> list[Observation]:
        if (self.columnar and isinstance(configs, RowBatch)
                and configs.compiled is self.space.compiled):
            res = self._run_rows(configs.rows)
            if isinstance(res, BudgetExhausted):
                raise res
            return res
        if not self.columnar:
            return super().run_batch(configs)
        cols = self.cache.columns
        space = self.space
        memo = self.memo
        budget = self.budget
        trace = self.trace
        records = cols.records
        time_list, charge_list = cols.time_list, cols.charge_list
        index_get = cols.index.get
        memo_get = memo.get
        append = trace.append
        new_obs = Observation.__new__
        out: list[Observation] = []
        # budget accounting is mirrored in locals (same left-to-right float
        # accumulation as Budget.charge, minus per-eval attribute churn) and
        # synced back even when BudgetExhausted aborts the batch mid-way
        max_s, max_e = budget.max_seconds, budget.max_evals
        spent_s, spent_e = budget.spent_seconds, budget.spent_evals
        fresh = self.fresh_evals
        mean_charge: float | None = None
        try:
            start, step = 0, self.BATCH_CHUNK_MIN
            while start < len(configs):
                chunk = configs[start:start + step]
                start += step
                step = min(step * 2, self.BATCH_CHUNK_MAX)
                for key, config in zip(space.config_ids(chunk), chunk):
                    obs = memo_get(key)
                    if obs is None:
                        if (max_s is not None and spent_s >= max_s) or \
                           (max_e is not None and spent_e >= max_e):
                            # sync, then raise through Budget.check so the
                            # exception (and its message) match the scalar
                            # path exactly
                            budget.spent_seconds = spent_s
                            budget.spent_evals = spent_e
                            budget.check()
                        row = index_get(key, -1)
                        if row >= 0:
                            result = records[row]
                            status = result.status
                            value = time_list[row]
                            charge = charge_list[row]
                        else:
                            # outside the recorded set: a failed compile at
                            # the mean charge, like the scalar path (and
                            # the same clear error on an empty cache)
                            if mean_charge is None:
                                mean_charge = self.cache.mean_eval_charge()
                            charge = mean_charge
                            result = CachedResult("error", INVALID, (), charge)
                            status, value = "error", INVALID
                        spent_s += charge
                        spent_e += 1
                        fresh += 1
                        # frozen-dataclass fast construction: __init__ pays
                        # object.__setattr__ per field, which dominates the
                        # commit at replay rates; filling __dict__ directly
                        # builds an identical instance (__eq__/fields/hash
                        # semantics unchanged)
                        obs = new_obs(Observation)
                        obs.__dict__.update(config=config, value=value,
                                            status=status, charge_s=charge,
                                            result=result)
                        memo[key] = obs
                        append((spent_s, value, config))
                    out.append(obs)
        finally:
            budget.spent_seconds = spent_s
            budget.spent_evals = spent_e
            self.fresh_evals = fresh
        return out


def run_fused(batches: "Sequence[tuple[Runner, Sequence[Config]]]"
              ) -> list:
    """Resolve several runners' batches back-to-back without loop overhead.

    ``batches`` is ``[(runner, configs), ...]`` — one entry per concurrent
    tuning run (see ``driver.drive_many``). Returns one element per entry:
    the ``list[Observation]`` that ``runner.run_batch(configs)`` would have
    returned, or the ``BudgetExhausted`` it would have raised (with the
    runner's committed state — memo, trace, budget — identical in both
    cases, partial results included).

    Since the index-native refactor the shared work the fusion used to do
    — batching config-id computation across runs — no longer exists:
    strategies ask in ``RowBatch`` form, and a columnar runner resolves
    rows with no key work at all (``SimulationRunner._run_rows``:
    population-sized segments through a tight integer loop, large segments
    through whole-array commits). Anything else — thread-bridged legacy
    asks, scalar runners, plain config lists — goes through its runner's
    own ``run_batch``, observably identical either way. Runners are
    independent (own memo/budget/trace), so per-runner observable order is
    preserved exactly.
    """
    out: list = []
    for runner, configs in batches:
        if (isinstance(configs, RowBatch)
                and isinstance(runner, SimulationRunner) and runner.columnar
                and configs.compiled is runner.space.compiled):
            out.append(runner._run_rows(configs.rows))
        else:
            try:
                out.append(runner.run_batch(configs))
            except BudgetExhausted as e:
                out.append(e)
    return out


class CostModelRunner(Runner):
    def __init__(self, space: SearchSpace, workload: KernelWorkload,
                 device: DeviceModel, budget: Budget):
        super().__init__(space, budget)
        self.workload = workload
        self.device = device

    def _evaluate(self, config: Config) -> CachedResult:
        cid = self.space.config_id(config)
        est = estimate(self.workload, self.space.as_dict(config), self.device, cid)
        return CachedResult(est.status, est.time_s, tuple(est.times_s),
                            est.compile_s, self.device.overhead_s)


class LiveRunner(Runner):
    """Times ``fn(config_dict)`` with the host clock; ``fn`` must wait for
    the device before it returns.

    The first call is recorded as ``compile_s``: on the card no
    configuration compiles (the kernel takes its tiling at run time), so it
    is a warm-up launch. Only ``ConfigRejected`` — a tiling the kernel
    cannot run, found before launch or as a launch the CUDA driver
    refused — is a failed config. Every other exception propagates: on
    CUDA a fault inside a kernel is sticky, and swallowing it would record
    every later evaluation as an error too."""

    def __init__(self, space: SearchSpace, fn: Callable, budget: Budget,
                 repeats: int = 3):
        super().__init__(space, budget)
        self.fn = fn
        self.repeats = repeats

    def _evaluate(self, config: Config) -> CachedResult:
        d = self.space.as_dict(config)
        t0 = time.perf_counter()
        try:
            self.fn(d)  # warmup/compile
            compile_s = time.perf_counter() - t0
            times = []
            for _ in range(self.repeats):
                t1 = time.perf_counter()
                self.fn(d)
                times.append(time.perf_counter() - t1)
            return CachedResult("ok", sum(times) / len(times), tuple(times),
                                compile_s)
        except ConfigRejected:
            # a rejected config still cost the measured wall time
            return CachedResult("error", INVALID, (),
                                time.perf_counter() - t0)

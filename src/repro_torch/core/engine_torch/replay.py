"""The replay-from-log path on the card: bit-identical to the numpy engine.

Port of ``src/repro/core/engine_jax/replay.py``. The jitted ``lax.scan``
(``budget_scan`` + ``_replay_segment``, vmapped over runs) becomes the
hand-written CUDA kernel ``csrc/budget_scan.cu``: one thread per run walks
its row segment left to right, gathering value and charge through
``col_of_row`` and accumulating the spend with the exact float64 additions
of the scalar loop and ``np.cumsum``. ``budget_scan`` below is its wrapper;
``budget_scan_plain`` is the same function in plain PyTorch (a float64 loop
over the segment, vectorised across runs; ``torch.cumsum`` is banned there
too, because any parallel scan reassociates the sums and drifts by ULPs).

Within-batch first-occurrence dedup stays on the host (the same stable
argsort as ``SimulationRunner._commit_rows_vectorized``), so ``fresh``
arrives fully resolved and the kernel only applies the budget to it.
Batches are padded to power-of-two lengths, as in the reference.

Every batch with a fresh row dispatches, single rows included: the host
round trip per small batch (a GA generation, one simulated-annealing move)
is the price of this slice, measured rather than hidden (PERF.md).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ... import cuda
from ..budget import BudgetExhausted
from ..cache import CachedResult
from ..runner import Observation
from .tables import ReplayTables, replay_tables

INVALID = float("inf")
_PAD_MIN = 8
# unlimited-budget stand-ins (per-run device scalars cannot be None)
_NO_MAX_S = float("inf")
_NO_MAX_E = 2 ** 62

# kernel launches by ``budget_scan`` (plain-version calls do not count)
launches = 0


def _pad_len(n: int) -> int:
    return max(_PAD_MIN, 1 << max(0, int(n - 1).bit_length()))


def first_occurrence(rows: np.ndarray) -> np.ndarray:
    """Host-side within-batch dedup mask — the exact stable-argsort
    first-occurrence computation of ``_commit_rows_vectorized``."""
    n = len(rows)
    order = np.argsort(rows, kind="stable")
    sorted_rows = rows[order]
    first_sorted = np.empty(n, dtype=bool)
    first_sorted[:1] = True
    first_sorted[1:] = sorted_rows[1:] != sorted_rows[:-1]
    first = np.empty(n, dtype=bool)
    first[order] = first_sorted
    return first


# ------------------------------------------------------------------ kernel
def budget_scan_plain(rows, fresh, col_of_row, time_s, charge_s,
                      mean_charge: float, spent0, evals0, max_s, max_e
                      ) -> tuple:
    """The kernel's function in plain PyTorch, on any device.

    ``rows`` int64 (R, N) space rows, ``fresh`` bool (R, N); per-run
    ``spent0``/``max_s`` float64 and ``evals0``/``max_e`` int64, all (R,).
    Returns ``(accept, t_after, value, charge, spent, evals, exhausted)``:
    the commit mask, the spend after each entry, the gathered value and
    charge, the final spend and eval count, and whether any fresh entry was
    refused (the ``BudgetExhausted`` point of the equivalent ``run``
    loop)."""
    col = col_of_row[rows].long()
    miss = col < 0
    safe = col.clamp(min=0)
    value = torch.where(miss, torch.full_like(time_s[safe], INVALID),
                        time_s[safe])
    charge = torch.where(miss, torch.full_like(charge_s[safe], mean_charge),
                         charge_s[safe])
    spent, evals = spent0.clone(), evals0.clone()
    accept = torch.zeros_like(fresh)
    t_after = torch.empty_like(charge)
    for j in range(rows.shape[1]):
        commit = fresh[:, j] & (spent < max_s) & (evals < max_e)
        spent = torch.where(commit, spent + charge[:, j], spent)
        evals = evals + commit.long()
        accept[:, j] = commit
        t_after[:, j] = spent
    exhausted = (fresh & ~accept).any(dim=1)
    return accept, t_after, value, charge, spent, evals, exhausted


def _lib() -> ctypes.CDLL:
    lib = cuda.library("budget_scan")
    fn = lib.repro_budget_scan
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_double]
                       + [ctypes.c_void_p] * 4
                       + [ctypes.c_int, ctypes.c_longlong]
                       + [ctypes.c_void_p] * 8)
    return lib


_ARG_TYPES = (("rows", torch.int64, 2), ("fresh", torch.bool, 2),
              ("col_of_row", torch.int32, 1), ("time_s", torch.float64, 1),
              ("charge_s", torch.float64, 1), ("spent0", torch.float64, 1),
              ("evals0", torch.int64, 1), ("max_s", torch.float64, 1),
              ("max_e", torch.int64, 1))


def budget_scan(rows, fresh, col_of_row, time_s, charge_s,
                mean_charge: float, spent0, evals0, max_s, max_e) -> tuple:
    """``budget_scan_plain``'s function: the CUDA kernel for tensors on the
    card, the plain version for tensors on the CPU. Rows must lie in
    ``[0, len(col_of_row))`` — callers check on the host, where the rows
    come from (an out-of-range row would read outside the table)."""
    global launches
    args = (rows, fresh, col_of_row, time_s, charge_s, spent0, evals0,
            max_s, max_e)
    device = rows.device
    for (name, dtype, ndim), t in zip(_ARG_TYPES, args):
        if t.dtype != dtype or t.dim() != ndim or t.device != device:
            raise ValueError(f"budget_scan: {name} must be a {ndim}-D "
                             f"{dtype} tensor on {device}, got a "
                             f"{t.dim()}-D {t.dtype} tensor on {t.device}")
    runs, n = rows.shape
    if tuple(fresh.shape) != (runs, n) or any(
            t.shape[0] != runs for t in (spent0, evals0, max_s, max_e)):
        raise ValueError("budget_scan: per-run shapes disagree with rows")
    if device.type == "cpu":
        return budget_scan_plain(rows, fresh, col_of_row, time_s, charge_s,
                                 mean_charge, spent0, evals0, max_s, max_e)
    if device.type != "cuda":
        raise ValueError(f"budget_scan runs on CUDA or the CPU, not {device}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("budget_scan takes contiguous tensors")
    if runs > np.iinfo(np.int32).max:
        raise ValueError(f"budget_scan: {runs} runs exceed one launch")
    accept = torch.empty((runs, n), dtype=torch.bool, device=device)
    t_after = torch.empty((runs, n), dtype=torch.float64, device=device)
    value = torch.empty_like(t_after)
    charge = torch.empty_like(t_after)
    spent = torch.empty(runs, dtype=torch.float64, device=device)
    evals = torch.empty(runs, dtype=torch.int64, device=device)
    exhausted = torch.empty(runs, dtype=torch.bool, device=device)
    if runs == 0:
        return accept, t_after, value, charge, spent, evals, exhausted
    lib = _lib()
    rc = lib.repro_budget_scan(
        rows.data_ptr(), fresh.data_ptr(), col_of_row.data_ptr(),
        time_s.data_ptr(), charge_s.data_ptr(), float(mean_charge),
        spent0.data_ptr(), evals0.data_ptr(), max_s.data_ptr(),
        max_e.data_ptr(), runs, n, accept.data_ptr(), t_after.data_ptr(),
        value.data_ptr(), charge.data_ptr(), spent.data_ptr(),
        evals.data_ptr(), exhausted.data_ptr(), cuda.stream_handle(device))
    cuda.check_launch(lib, rc, "budget_scan")
    launches += 1
    return accept, t_after, value, charge, spent, evals, exhausted


def _budget_limits(budget) -> tuple:
    max_s = _NO_MAX_S if budget.max_seconds is None else float(budget.max_seconds)
    max_e = _NO_MAX_E if budget.max_evals is None else int(budget.max_evals)
    return max_s, max_e


def _check_rows(rows: np.ndarray, n_valid: int) -> None:
    if rows.size and (rows.min() < 0 or rows.max() >= n_valid):
        raise IndexError(f"space rows outside [0, {n_valid})")


# ---------------------------------------------------------------- engine
class ReplayEngine:
    """Row-batch resolution for one ``SimulationRunner`` on its device.

    The host stays the source of truth: observations, memo, trace, and
    budget commit exactly as ``_commit_rows_vectorized`` does, from arrays
    the kernel computed. Every batch containing a fresh row dispatches —
    including single-row asks; fully-memoized batches short-circuit to the
    same pure host gather as the numpy path (no engine semantics involved).
    The device is read from the runner at every dispatch.
    """

    def __init__(self, runner):
        self.runner = runner
        self.dispatches = 0  # budget-scan dispatches (kernel or plain)

    def commit_rows(self, rows) -> "list | BudgetExhausted":
        runner = self.runner
        rows = np.asarray(rows, dtype=np.int64)
        n = len(rows)
        seen, obs_by_row, col_of_row, _col_list, cols = runner._row_state()
        if len(cols) == 0:
            # empty cache: every row is an imputed miss and
            # mean_eval_charge's clear error must surface at the exact
            # point the scalar path raises it — keep that on the host
            return runner._commit_rows_loop(rows)
        _check_rows(rows, len(seen))
        seen_rows = seen[rows]
        if seen_rows.all():
            # revisit-only batch: pure memo gather, nothing to account
            return [obs_by_row[r] for r in rows.tolist()]
        fresh = first_occurrence(rows) & ~seen_rows
        col_rows = col_of_row[rows]
        mean_charge = (runner.cache.mean_eval_charge()
                       if (col_rows[fresh] < 0).any() else 0.0)
        budget = runner.budget
        max_s, max_e = _budget_limits(budget)
        npad = _pad_len(n)
        rows_p = np.zeros((1, npad), dtype=np.int64)
        rows_p[0, :n] = rows
        fresh_p = np.zeros((1, npad), dtype=bool)
        fresh_p[0, :n] = fresh
        tables = replay_tables(cols, runner.space.compiled, runner.device)
        dev = tables.device
        self.dispatches += 1
        out = budget_scan(
            torch.from_numpy(rows_p).to(dev), torch.from_numpy(fresh_p).to(dev),
            tables.col_of_row, tables.time_s, tables.charge_s, mean_charge,
            torch.tensor([budget.spent_seconds], dtype=torch.float64,
                         device=dev),
            torch.tensor([budget.spent_evals], dtype=torch.int64, device=dev),
            torch.tensor([max_s], dtype=torch.float64, device=dev),
            torch.tensor([max_e], dtype=torch.int64, device=dev))
        accept, t_after, value, charge, spent, evals, exhausted = (
            o[0].cpu().numpy() for o in out)
        # ------------------------------------------------- host-side commit
        # (mirrors _commit_rows_vectorized: fresh commits build
        # Observations, revisits gather from the row-indexed object array)
        acc_idx = np.nonzero(accept[:n])[0]
        cut = len(acc_idx)
        if cut:
            acc_rows = rows[acc_idx]
            acc_cols = col_rows[acc_idx]
            seen[acc_rows] = True
            vals = value[acc_idx].tolist()
            chgs = charge[acc_idx].tolist()
            cs = runner.space.compiled
            cfg_tab, id_tab = cs.configs, cs.ids
            cfgs_acc = [cfg_tab[r] for r in acc_rows.tolist()]
            records = cols.records
            new_obs = Observation.__new__
            set_dict = object.__setattr__
            memo = runner.memo
            for r, col, cfg, val, chg in zip(acc_rows.tolist(),
                                             acc_cols.tolist(),
                                             cfgs_acc, vals, chgs):
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
            runner.trace.extend(zip(t_after[acc_idx].tolist(), vals,
                                    cfgs_acc))
            budget.spent_seconds = float(spent)
            budget.spent_evals = int(evals)
            runner.fresh_evals += cut
            runner._rows_memo_len = len(memo)
        if exhausted:
            try:
                budget.check()  # same exception/message as the scalar path
            except BudgetExhausted as exc:
                return exc
        return [obs_by_row[r] for r in rows.tolist()]


def replay_many(cols, compiled, rows_matrix, *, seen=None,
                spent0=None, evals0=None, max_seconds=None, max_evals=None,
                mean_charge: float = 0.0,
                tables: "ReplayTables | None" = None,
                device: str | None = None) -> tuple:
    """Fused fresh-replay: resolve R concurrent runs' row segments in one
    kernel launch.

    ``rows_matrix`` is (R, N) int rows; per-run scalars broadcast from
    Python numbers or arrive as (R,) arrays. Returns tensors on the device
    ``(accept, t_after, value, charge, spent, evals, exhausted)`` — each
    run's slice bit-identical to what a ``SimulationRunner`` replaying the
    same segment would commit. Rows must be within-run unique (fresh
    replay) unless a precomputed ``seen`` basis makes duplicates revisits;
    for general logs use ``ReplayEngine``. ``device`` defaults to the
    tables' device, else the card.
    """
    if tables is None:
        tables = replay_tables(cols, compiled, cuda.resolve_device(device))
    dev = tables.device
    rows_matrix = np.asarray(rows_matrix, dtype=np.int64)
    _check_rows(rows_matrix, tables.n_valid)
    runs, _n = rows_matrix.shape
    rows_d = torch.from_numpy(rows_matrix).to(dev)
    if seen is None:
        fresh = torch.ones(rows_matrix.shape, dtype=torch.bool, device=dev)
    else:
        seen_d = torch.as_tensor(np.asarray(seen, dtype=bool)).to(dev)
        fresh = (~seen_d[rows_d] if seen_d.dim() == 1
                 else ~torch.gather(seen_d, 1, rows_d))

    def per_run(x, default, dtype):
        arr = torch.as_tensor(default if x is None else x, dtype=dtype)
        return arr.to(dev).expand(runs).contiguous()

    return budget_scan(
        rows_d, fresh.contiguous(), tables.col_of_row, tables.time_s,
        tables.charge_s, mean_charge,
        per_run(spent0, 0.0, torch.float64),
        per_run(evals0, 0, torch.int64),
        per_run(max_seconds, _NO_MAX_S, torch.float64),
        per_run(max_evals, _NO_MAX_E, torch.int64))

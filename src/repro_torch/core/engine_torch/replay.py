"""The replay-from-log path on the card: bit-identical to the numpy engine.

Port of ``src/repro/core/engine_jax/replay.py``. The jitted ``lax.scan``
(``budget_scan`` + ``_replay_segment``, vmapped over runs) becomes the
hand-written CUDA kernel ``csrc/budget_scan.cu``: a warp per run gathers
value and charge through ``col_of_row`` for a chunk of its segment at once,
and one lane then walks the chunk's charges with the exact left-to-right
float64 additions of the scalar loop and ``np.cumsum``.
``budget_scan`` below is its wrapper; ``budget_scan_plain`` is the same
function in plain PyTorch (a float64 loop over the segment, vectorised
across runs; ``torch.cumsum`` is banned there too, because any parallel
scan reassociates the sums and drifts by ULPs).

Within-batch first-occurrence dedup stays on the host (the same stable
argsort as ``SimulationRunner._commit_rows_vectorized``), so ``fresh``
arrives fully resolved and the kernel only applies the budget to it.
Batches are padded to power-of-two lengths, as in the reference.

Every batch with a fresh row dispatches, single rows included. A
``ReplayEngine`` call packs its inputs into one block (``ScanLayout``), so
it costs one copy to the card, one launch, one copy back and one
synchronisation (``ScanBlocks``). A fused campaign (``campaign.py``) makes
the same packed call with all of a group's runs at once.
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
                      mean_charge: float, spent0, evals0, max_s, max_e,
                      out: "tuple | None" = None) -> tuple:
    """The kernel's function in plain PyTorch, on any device.

    ``rows`` int64 (R, N) space rows, ``fresh`` bool (R, N); per-run
    ``spent0``/``max_s`` float64 and ``evals0``/``max_e`` int64, all (R,).
    Returns ``(accept, t_after, value, charge, spent, evals, exhausted)``:
    the commit mask, the spend after each entry, the gathered value and
    charge, the final spend and eval count, and whether any fresh entry was
    refused (the ``BudgetExhausted`` point of the equivalent ``run``
    loop). ``out``, seven tensors of those shapes and types, receives the
    results in place of new tensors."""
    runs, n = rows.shape
    if out is None:
        out = (torch.empty_like(fresh),
               *(torch.empty((runs, n), dtype=torch.float64,
                             device=rows.device) for _ in range(3)),
               torch.empty_like(spent0), torch.empty_like(evals0),
               torch.empty(runs, dtype=torch.bool, device=rows.device))
    accept, t_after, value, charge, spent, evals, exhausted = out
    col = col_of_row[rows].long()
    miss = col < 0
    safe = col.clamp(min=0)
    torch.where(miss, torch.full_like(time_s[safe], INVALID), time_s[safe],
                out=value)
    torch.where(miss, torch.full_like(charge_s[safe], mean_charge),
                charge_s[safe], out=charge)
    spent.copy_(spent0)
    evals.copy_(evals0)
    for j in range(n):
        commit = fresh[:, j] & (spent < max_s) & (evals < max_e)
        spent.copy_(torch.where(commit, spent + charge[:, j], spent))
        evals.add_(commit.long())
        accept[:, j] = commit
        t_after[:, j] = spent
    exhausted.copy_((fresh & ~accept).any(dim=1))
    return out


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


def _launch(rows, fresh, col_of_row, time_s, charge_s, mean_charge: float,
            spent0, evals0, max_s, max_e, runs: int, n: int, accept,
            t_after, value, charge, spent, evals, exhausted,
            device: torch.device) -> None:
    """Launch the kernel on device pointers (ints); counts the launch."""
    global launches
    lib = _lib()
    rc = lib.repro_budget_scan(
        rows, fresh, col_of_row, time_s, charge_s, float(mean_charge),
        spent0, evals0, max_s, max_e, runs, n, accept, t_after, value,
        charge, spent, evals, exhausted, cuda.stream_handle(device))
    cuda.check_launch(lib, rc, "budget_scan")
    launches += 1


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
    out = (accept, t_after, value, charge, spent, evals, exhausted)
    if runs:
        _launch(*(t.data_ptr() for t in args[:5]), mean_charge,
                *(t.data_ptr() for t in args[5:]), runs, n,
                *(t.data_ptr() for t in out), device)
    return out


# ------------------------------------------------------------ packed call
# The fields of a call's two blocks, (name, dtype, per): "entry" fields are
# (runs, npad), "run" fields (runs,). The 8-byte fields come first and the
# byte fields last, so every field starts on a multiple of 8 bytes.
IN_FIELDS = (("rows", torch.int64, "entry"), ("spent0", torch.float64, "run"),
             ("evals0", torch.int64, "run"), ("max_s", torch.float64, "run"),
             ("max_e", torch.int64, "run"), ("fresh", torch.bool, "entry"))
OUT_FIELDS = (("t_after", torch.float64, "entry"),
              ("value", torch.float64, "entry"),
              ("charge", torch.float64, "entry"),
              ("spent", torch.float64, "run"), ("evals", torch.int64, "run"),
              ("accept", torch.bool, "entry"),
              ("exhausted", torch.bool, "run"))
# budget_scan_plain's result order
OUT_ORDER = ("accept", "t_after", "value", "charge", "spent", "evals",
             "exhausted")


class ScanLayout:
    """Where each field of a call's input and output blocks lies: byte
    offsets for ``runs`` runs of ``npad`` entries, every one a multiple of
    8. Checks the fields' types and alignment once, when it is made."""

    __slots__ = ("runs", "npad", "offsets", "nbytes")

    def __init__(self, runs: int, npad: int):
        self.runs, self.npad = runs, npad
        self.offsets, self.nbytes = {}, {}
        for block, fields in (("in", IN_FIELDS), ("out", OUT_FIELDS)):
            off = 0
            for name, dtype, per in fields:
                if off % 8:
                    raise ValueError(f"ScanLayout: {name} would start at "
                                     f"byte {off}, not a multiple of 8")
                self.offsets[name] = off
                off += self.numel(per) * dtype.itemsize
            self.nbytes[block] = -(-off // 8) * 8

    def numel(self, per: str) -> int:
        return self.runs * (self.npad if per == "entry" else 1)

    def shape(self, per: str) -> tuple:
        return (self.runs, self.npad) if per == "entry" else (self.runs,)

    def views(self, block: torch.Tensor, fields) -> dict:
        """Typed tensor views of ``fields`` into the uint8 ``block``."""
        out = {}
        for name, dtype, per in fields:
            off = self.offsets[name]
            size = self.numel(per) * dtype.itemsize
            out[name] = block[off:off + size].view(dtype).view(
                self.shape(per))
        return out


class ScanBlocks:
    """Packed call blocks on ``device``: a host staging block and a device
    block for each direction, allocated at first use and grown to the
    largest byte size a call asked for. A call lays out ``runs`` runs of
    ``npad`` entries in them (``ScanLayout``; each layout is made once and
    kept until the blocks grow). On the card the host blocks are pinned
    and a call is one ``copy_(non_blocking=True)`` in, one launch on
    pointers into the device blocks, one copy out and one
    synchronisation. On the CPU the same blocks are ordinary tensors, and
    the plain version reads and writes the device blocks' views. A
    ``ReplayEngine`` calls with one run; a fused campaign
    (``campaign.py``) with a group's runs. Never pickled."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.capacity = 0  # the largest npad laid out so far
        self.nbytes = {"in": 0, "out": 0}  # the blocks' sizes
        self._calls: dict = {}  # (runs, npad) -> its views and pointers

    def _grow(self, layout: ScanLayout) -> None:
        pin = self.device.type == "cuda"
        self.nbytes = {k: max(v, layout.nbytes[k])
                       for k, v in self.nbytes.items()}

        def block(nbytes, device, pinned=False):
            return torch.empty(nbytes, dtype=torch.uint8, device=device,
                               pin_memory=pinned)

        self.host_in = block(self.nbytes["in"], "cpu", pin)
        self.dev_in = block(self.nbytes["in"], self.device)
        self.dev_out = block(self.nbytes["out"], self.device)
        self.host_out = block(self.nbytes["out"], "cpu", pin)
        self._calls = {}

    def call(self, npad: int, runs: int = 1) -> tuple:
        """``(inputs, outputs)``: numpy views of the host blocks laid out
        for ``runs`` runs of ``npad`` entries (``ScanLayout``'s fields by
        name). Write the inputs, then ``run``; the outputs hold its
        results until the next call."""
        c = self._calls.get((runs, npad))
        if c is None:
            layout = ScanLayout(runs, npad)
            if any(layout.nbytes[k] > v for k, v in self.nbytes.items()):
                self._grow(layout)
            c = self._calls[runs, npad] = self._lay_out(layout)
            self.capacity = max(self.capacity, npad)
        return c["host_in"], c["host_out"]

    def device_views(self, npad: int, runs: int = 1) -> tuple:
        """``(inputs, outputs)``: the device blocks' tensor views laid out
        for ``runs`` runs of ``npad``, as the last ``run`` of that layout
        read and wrote them."""
        c = self._calls[runs, npad]
        return c["dev_in"], c["dev_out"]

    def _lay_out(self, layout: ScanLayout) -> dict:
        nin, nout = layout.nbytes["in"], layout.nbytes["out"]
        dev_in = layout.views(self.dev_in, IN_FIELDS)
        dev_out = layout.views(self.dev_out, OUT_FIELDS)
        return {"host_in": {k: v.numpy() for k, v in
                            layout.views(self.host_in, IN_FIELDS).items()},
                "host_out": {k: v.numpy() for k, v in
                             layout.views(self.host_out, OUT_FIELDS).items()},
                "copy_in": (self.dev_in[:nin], self.host_in[:nin]),
                "copy_out": (self.host_out[:nout], self.dev_out[:nout]),
                "dev_in": dev_in, "dev_out": dev_out,
                "in_ptrs": {k: v.data_ptr() for k, v in dev_in.items()},
                "out_ptrs": {k: v.data_ptr() for k, v in dev_out.items()}}

    def run(self, npad: int, tables: ReplayTables, mean_charge: float,
            runs: int = 1) -> None:
        """Resolve the inputs written into ``call(npad, runs)``'s views;
        the results land in its output views."""
        c = self._calls[runs, npad]
        dst, src = c["copy_in"]
        dst.copy_(src, non_blocking=True)
        if self.device.type == "cpu":
            i = c["dev_in"]
            budget_scan_plain(
                i["rows"], i["fresh"], tables.col_of_row, tables.time_s,
                tables.charge_s, mean_charge, i["spent0"], i["evals0"],
                i["max_s"], i["max_e"],
                out=tuple(c["dev_out"][name] for name in OUT_ORDER))
        else:
            i, o = c["in_ptrs"], c["out_ptrs"]
            _launch(i["rows"], i["fresh"], tables.col_of_row.data_ptr(),
                    tables.time_s.data_ptr(), tables.charge_s.data_ptr(),
                    mean_charge, i["spent0"], i["evals0"], i["max_s"],
                    i["max_e"], runs, npad,
                    *(o[name] for name in OUT_ORDER), self.device)
        dst, src = c["copy_out"]
        dst.copy_(src, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()


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
        self._blocks: "ScanBlocks | None" = None

    def blocks(self) -> ScanBlocks:
        """The packed call blocks on the runner's current device."""
        blocks = self._blocks
        if blocks is None or blocks.device != torch.device(
                self.runner.device):
            blocks = self._blocks = ScanBlocks(self.runner.device)
        return blocks

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
        tables = replay_tables(cols, runner.space.compiled, runner.device)
        blocks = self.blocks()
        inp, out = blocks.call(npad)
        inp["rows"][0, :n] = rows
        inp["rows"][0, n:] = 0
        inp["fresh"][0, :n] = fresh
        inp["fresh"][0, n:] = False
        inp["spent0"][0] = budget.spent_seconds
        inp["evals0"][0] = budget.spent_evals
        inp["max_s"][0] = max_s
        inp["max_e"][0] = max_e
        self.dispatches += 1
        blocks.run(npad, tables, mean_charge)
        accept, t_after, value, charge = (out[k][0] for k in (
            "accept", "t_after", "value", "charge"))
        spent, evals, exhausted = (out[k][0] for k in (
            "spent", "evals", "exhausted"))
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

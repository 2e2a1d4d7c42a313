"""Parallel, resumable campaign execution (paper Sec. III-C/E at scale).

The paper's headline results require thousands of simulated tuning campaigns:
+94.8 % from exhaustive hyperparameter tuning (Sec. IV-B, Table III) and
+204.7 % from meta-strategies (Sec. IV-C, Table IV). The simulation mode
already removes the hardware from the loop (Sec. III-C, ~130× cheaper than
live tuning — Fig. 9); this module removes the single-process bottleneck and
makes long campaigns interruptible:

  * ``CampaignExecutor`` — fans independent scoring tasks (one hyperparameter
    configuration, or one (space, repeat) cell of the methodology's inner
    loop) out over a ``concurrent.futures`` worker pool.
  * ``CampaignJournal`` — an append-only JSONL checkpoint. Every completed
    ``AggregateReport`` is persisted the moment it finishes, so an
    interrupted ``exhaustive_hypertune``/``meta_hypertune`` resumes without
    re-scoring anything.

Determinism: every task seeds its own RNG from ``(seed, space, repeat)``
(see ``methodology.run_repeat``), and partial results are reduced in the
same fixed enumeration order as the serial loop — so parallel campaigns are
bit-identical to serial ones regardless of worker count, backend, or task
completion order.

Port copy of ``src/repro/core/parallel.py``
and kept as its own copy: the port imports nothing of ``repro``. One
change: a process pool whose shared payload holds a torch-engine scorer
starts its workers with ``spawn`` (a child forked after CUDA was
initialised cannot use CUDA); other pools keep the default start method.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import multiprocessing
import os
import pickle
import time
from concurrent.futures import (FIRST_COMPLETED, ProcessPoolExecutor,
                                ThreadPoolExecutor, wait)
from typing import Any, Callable, Iterator, Mapping, Sequence

import numpy as np

from .methodology import AggregateReport, SpaceScorer, evaluate_strategy
from .strategies import get_strategy

JOURNAL_FORMAT = "repro-campaign"
JOURNAL_VERSION = 1


# ------------------------------------------------------------- task payloads
@dataclasses.dataclass(frozen=True)
class StrategyFactory:
    """Picklable ``make_strategy`` for ``methodology.evaluate_strategy``.

    The serial API accepts any zero-argument callable (often a lambda);
    process workers need a payload that survives pickling, so the factory
    stores the registry name plus sorted hyperparameter items and rebuilds
    the strategy on call — the same late construction per repeat that the
    methodology requires (fresh strategy state per run, Sec. III-B).
    """

    name: str
    hyperparams: tuple  # sorted ((key, value), ...) pairs

    @staticmethod
    def create(name: str, hyperparams: Mapping) -> "StrategyFactory":
        return StrategyFactory(name, tuple(sorted(hyperparams.items())))

    def __call__(self):
        return get_strategy(self.name, **dict(self.hyperparams))


def score_hyperconfig_task(scorers: Sequence[SpaceScorer], strategy_name: str,
                           hyperparams: Mapping, repeats: int,
                           seed: int) -> AggregateReport:
    """Score one hyperparameter configuration (one cell of the paper's
    Table III grid) with the methodology — the unit of work an exhaustive
    campaign fans out. Module-level (not a closure) so process-pool workers
    can receive it by reference; ``scorers`` comes first so campaigns can
    ship it once per worker via ``CampaignExecutor.map(shared=scorers)``."""
    return evaluate_strategy(StrategyFactory.create(strategy_name, hyperparams),
                             scorers, repeats=repeats, seed=seed)


# ----------------------------------------------------- process-pool plumbing
# Campaign-constant context (e.g. the scorer list with its megabyte-scale
# baseline arrays) is pickled once per worker process through the pool
# initializer rather than once per task — the difference between shipping a
# few MB and a few GB over the pipe for a Table III-sized grid.
_SHARED: Any = None


def _init_shared(payload: bytes) -> None:
    global _SHARED
    _SHARED = pickle.loads(payload)


def _call_with_shared(fn: Callable, args: tuple) -> Any:
    return fn(_SHARED, *args)


# Chunked task wrappers: one pool submission evaluates a whole slice of the
# task grid. The vectorized scoring engine made individual (space, repeat)
# cells cheap enough that per-task IPC (submit + pickle + result wakeup)
# dominates small tasks on a process pool; chunking amortizes it without
# changing results (cells are still reduced in index order by the caller).
def _run_chunk(fn: Callable, argtuples: Sequence[tuple]) -> list:
    return [fn(*args) for args in argtuples]


def _run_chunk_shared(fn: Callable, shared: Any,
                      argtuples: Sequence[tuple]) -> list:
    return [fn(shared, *args) for args in argtuples]


def _run_chunk_global(fn: Callable, argtuples: Sequence[tuple]) -> list:
    return [fn(_SHARED, *args) for args in argtuples]


def _holds_torch_scorer(payload: Any) -> bool:
    """Whether a shared payload (a scorer, or tuples/lists holding
    scorers) carries a scorer that replays through the torch engine."""
    if isinstance(payload, SpaceScorer):
        return payload.engine == "torch"
    if isinstance(payload, (tuple, list)):
        return any(_holds_torch_scorer(x) for x in payload)
    return False


# ---------------------------------------------------------------- executor
class CampaignExecutor:
    """Deterministic worker pool for campaign tasks (paper Sec. III-C/E).

    ``workers <= 1`` (the default) runs tasks inline — serial execution is
    just the degenerate pool, so call sites need no branching. Backends:

      * ``"thread"``  — ``ThreadPoolExecutor``; always safe (shared memory,
        no pickling), speedup limited to the numpy portions of scoring.
      * ``"process"`` — ``ProcessPoolExecutor``; true parallelism, requires
        picklable tasks (hub caches loaded from disk and ``StrategyFactory``
        payloads are; ad-hoc lambdas are not).
      * ``"auto"``    — probe-pickle the first task: processes when the
        payload survives, threads otherwise.

    Results are yielded as ``(index, result)`` in completion order; callers
    that need serial-identical output reduce them in index order (see
    ``hypertuner.exhaustive_hypertune``), which together with per-task
    seeding keeps parallel scores bit-identical to serial ones.
    """

    def __init__(self, workers: int = 1, backend: str = "auto"):
        if backend not in ("auto", "serial", "thread", "process"):
            raise ValueError(f"unknown backend {backend!r}")
        self.workers = max(1, int(workers))
        self.backend = backend
        # pools are cached across map() calls (meta campaigns call map once
        # per hyperparameter evaluation); the process pool is keyed by its
        # shared payload, since workers are initialized with it
        self._thread_pool: ThreadPoolExecutor | None = None
        self._proc_pool: ProcessPoolExecutor | None = None
        self._proc_key: str | None = None
        self._auto_cache: dict[int, str] = {}  # id(fn) -> resolved backend

    # ------------------------------------------------------------- plumbing
    @property
    def parallel(self) -> bool:
        return self.workers > 1 and self.backend != "serial"

    def _resolve_backend(self, fn: Callable, argtuples: Sequence[tuple],
                         shared: Any) -> str:
        if not self.parallel or not argtuples:
            return "serial"
        if self.backend in ("thread", "process"):
            return self.backend
        hit = self._auto_cache.get(id(fn))
        if hit is None:  # auto: processes iff the payload pickles
            try:
                pickle.dumps((fn, shared, argtuples[0]))
                hit = "process"
            except Exception:
                hit = "thread"
            self._auto_cache[id(fn)] = hit
        return hit

    def _get_process_pool(self, shared: Any) -> ProcessPoolExecutor:
        payload = pickle.dumps(shared)
        key = hashlib.sha1(payload).hexdigest()
        if self._proc_pool is None or self._proc_key != key:
            if self._proc_pool is not None:
                self._proc_pool.shutdown(wait=True, cancel_futures=True)
            ctx = (multiprocessing.get_context("spawn")
                   if _holds_torch_scorer(shared) else None)
            self._proc_pool = ProcessPoolExecutor(
                max_workers=self.workers, mp_context=ctx,
                initializer=_init_shared, initargs=(payload,))
            self._proc_key = key
        return self._proc_pool

    def map(self, fn: Callable, argtuples: Sequence[tuple],
            shared: Any = None,
            chunksize: int = 1) -> Iterator[tuple[int, Any]]:
        """Run ``fn(*argtuples[i])`` — or ``fn(shared, *argtuples[i])`` when
        ``shared`` is given — for every i; yield ``(i, result)`` as tasks
        complete (serial: in submission order). ``shared`` is
        campaign-constant context shipped once per worker process instead of
        once per task; repeated ``map`` calls with an identical payload
        reuse the warm pool. ``chunksize > 1`` groups consecutive tasks
        into one pool submission (amortizing IPC for cheap tasks); results
        are still yielded per task with their original indices, so callers'
        index-order reductions — and therefore campaign scores — are
        unchanged at any chunk size. Exceptions propagate; on early
        generator close, unstarted tasks are cancelled — together with
        ``CampaignJournal`` this is what makes campaigns interruptible.
        """
        backend = self._resolve_backend(fn, argtuples, shared)
        if backend == "serial":
            for i, args in enumerate(argtuples):
                yield i, (fn(*args) if shared is None else fn(shared, *args))
            return
        chunksize = max(1, int(chunksize))
        chunks = [(start, argtuples[start:start + chunksize])
                  for start in range(0, len(argtuples), chunksize)]
        if backend == "thread":
            if self._thread_pool is None:
                self._thread_pool = ThreadPoolExecutor(
                    max_workers=self.workers)
            pool = self._thread_pool
            submit = (lambda chunk: pool.submit(_run_chunk, fn, chunk)
                      if shared is None
                      else pool.submit(_run_chunk_shared, fn, shared, chunk))
        else:
            pool = self._get_process_pool(shared)
            submit = (lambda chunk: pool.submit(_run_chunk, fn, chunk)
                      if shared is None
                      else pool.submit(_run_chunk_global, fn, chunk))
        futures = {}
        try:
            futures = {submit(chunk): start for start, chunk in chunks}
            pending = set(futures)
            while pending:
                done, pending = wait(pending, return_when=FIRST_COMPLETED)
                for fut in done:
                    start = futures[fut]
                    for off, res in enumerate(fut.result()):
                        yield start + off, res
        finally:
            for fut in futures:  # no-op for completed futures
                fut.cancel()

    def shutdown(self) -> None:
        """Tear down cached pools (idempotent)."""
        if self._thread_pool is not None:
            self._thread_pool.shutdown(wait=True, cancel_futures=True)
            self._thread_pool = None
        if self._proc_pool is not None:
            self._proc_pool.shutdown(wait=True, cancel_futures=True)
            self._proc_pool = None
            self._proc_key = None

    def __enter__(self) -> "CampaignExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


# ----------------------------------------------------------------- journal
class CampaignJournal:
    """Append-only JSONL checkpoint of a hypertuning campaign.

    Line 1 is a header identifying the campaign (mode, strategy, repeats,
    seed, search spaces); each further line is one completed hyperparameter
    evaluation. Records are flushed and fsync'd as they complete, so a
    campaign killed at any point resumes from its last finished
    configuration — the simulated analogue of the paper's concern that
    hyperparameter tuning is "considerably more expensive" than tuning
    itself (Sec. III-C): the expensive thing must never be recomputed.

    A truncated trailing line (interruption mid-write) is ignored on read.
    Resuming with different campaign settings raises, because mixing scores
    across methodologies would silently corrupt the comparison (Sec. III-B
    requires all scores to share baseline, budget, and repeats).

    ``fmt`` is the value of the header's ``format`` field; other append-only
    JSONL files (e.g. ``core.record``'s observation shards) reuse the same
    durability machinery under their own format tag.
    """

    def __init__(self, path: str, fmt: str = JOURNAL_FORMAT):
        self.path = path
        self.fmt = fmt

    # -------------------------------------------------------------- reading
    def read(self) -> tuple[dict | None, list[dict]]:
        """Return ``(header, records)``; ``(None, [])`` if no file yet."""
        if not os.path.exists(self.path):
            return None, []
        header: dict | None = None
        records: list[dict] = []
        with open(self.path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    d = json.loads(line)
                except json.JSONDecodeError:
                    if header is None:  # binary/foreign file, not a journal
                        raise ValueError(
                            f"{self.path} is not a {self.fmt} file")
                    # a line torn by an interrupted write (``append`` starts
                    # every record on a fresh line, so complete records are
                    # always intact lines) — skip it, keep later records
                    continue
                if header is None:
                    if d.get("format") != self.fmt:
                        raise ValueError(
                            f"{self.path} is not a {self.fmt} file "
                            f"(found format {d.get('format')!r})")
                    header = d
                else:
                    records.append(d)
        return header, records

    def ensure_header(self, header: Mapping) -> list[dict]:
        """Create the journal (writing ``header``) or validate that the
        existing one matches; returns the completed records to skip."""
        existing, records = self.read()
        if existing is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self.append(dict(header, format=self.fmt,
                             version=JOURNAL_VERSION))
            return []
        volatile = {"format", "version", "created_unix"}
        mismatched = {k: (existing.get(k), v) for k, v in header.items()
                      if k not in volatile and existing.get(k) != v}
        if mismatched:
            raise ValueError(
                f"journal {self.path} was written by a different campaign: "
                f"{mismatched}; use a fresh journal path")
        return records

    # -------------------------------------------------------------- writing
    def append(self, record: Mapping) -> None:
        """Durably append one JSON line (flush + fsync before returning).

        If the file ends mid-line (a write torn by ``kill -9``), a newline
        is inserted first so the new record starts on a fresh line — the
        torn fragment stays behind as one unparseable line that ``read``
        skips, and no later record is ever merged into it."""
        payload = json.dumps(record) + "\n"
        with open(self.path, "ab") as f:
            if f.tell() > 0 and not self._ends_with_newline():
                payload = "\n" + payload
            f.write(payload.encode("utf-8"))
            f.flush()
            os.fsync(f.fileno())

    def _ends_with_newline(self) -> bool:
        with open(self.path, "rb") as f:
            f.seek(-1, os.SEEK_END)
            return f.read(1) == b"\n"


# ----------------------------------------------- report (de)serialization
def report_to_json(report: AggregateReport) -> dict:
    """JSON form of an ``AggregateReport`` for journal records."""
    return {
        "score": report.score,
        "curve": report.curve.tolist(),
        "per_space": {k: v.tolist() for k, v in report.per_space.items()},
        "per_space_score": report.per_space_score,
        "fresh_evals": report.fresh_evals,
        "wall_seconds": report.wall_seconds,
        "simulated_seconds": report.simulated_seconds,
        "fuse": report.fuse,
    }


def report_from_json(d: Mapping) -> AggregateReport:
    """Inverse of ``report_to_json`` (scores round-trip exactly: python
    floats serialize losslessly through JSON)."""
    return AggregateReport(
        score=d["score"], curve=np.array(d["curve"]),
        per_space={k: np.array(v) for k, v in d["per_space"].items()},
        per_space_score=dict(d["per_space_score"]),
        fresh_evals=int(d.get("fresh_evals", 0)),
        wall_seconds=float(d.get("wall_seconds", 0.0)),
        simulated_seconds=float(d.get("simulated_seconds", 0.0)),
        # pre-fused journals carry no drive mode: "sequential" matches how
        # those campaigns actually ran
        fuse=str(d.get("fuse", "sequential")),
    )


def campaign_header(mode: str, strategy: str, scorers: Sequence[SpaceScorer],
                    repeats: int, seed: int, **extra) -> dict:
    """Identity of a campaign: everything that must match for two scores to
    be comparable under the methodology (Sec. III-B)."""
    return {"mode": mode, "strategy": strategy, "repeats": repeats,
            "seed": seed, "spaces": [s.name for s in scorers], **extra,
            "created_unix": time.time()}

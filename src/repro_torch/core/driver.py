"""Ask/tell search driver: the evaluate loop, extracted from the strategies.

The pre-refactor ``Strategy._optimize`` owned its own evaluate loop, which
made mid-run state invisible (no checkpointing inside a tuning run) and
forced every caller to run strategies one at a time. This module inverts
the control flow (paper Sec. III-E: the algorithm never perceives *how* its
evaluations are satisfied):

  * ``SearchState`` — explicit, picklable per-run strategy state. A
    strategy is a pure transition system over it: ``ask(state)`` proposes
    the next batch of configs, ``tell(state, observations)`` folds results
    back in. Pickling a state (plus the runner's ``state_dict``) suspends a
    tuning run mid-generation; unpickling resumes it bit-identically.
  * ``SearchDriver`` — owns budget handling, trace recording, and RNG
    stepping order. One ``step()`` = one ask → ``runner.run_batch`` → tell.
    ``BudgetExhausted`` terminates the run between ask and tell (exactly
    where the legacy imperative loops died), so a strategy never observes a
    partial batch.
  * ``drive_many`` — interleaves N concurrent runs and fuses their asks
    into shared columnar ``run_fused`` calls (see ``runner.run_fused``),
    turning the methodology's repeat grid into cross-run batches.

Two adapters convert imperative search loops into the protocol without
rewriting them as state machines:

  * ``GeneratorBridgeState`` — for strategies written as generators
    (``obs = yield configs``). Pure-Python loops (simulated annealing, the
    greedy local searches) read exactly as before, with each ``runner(x)``
    call replaced by a yield.
  * ``ThreadBridgeState`` — for strategies that drive a foreign callback
    API (``dual_annealing`` wrapping scipy): the legacy ``_optimize`` runs
    on a daemon thread against a proxy runner that rendezvous-hands each
    evaluation request to the ask side.

Neither adapter's runtime (generator frame, thread) can pickle; both
serialize as *replay logs*: the RNG's initial state plus the sequence of
observation batches told so far. Unpickling re-runs the strategy's own
(cheap, deterministic) compute against the recorded observations — no
kernel evaluation is repeated — and lands it in the exact mid-run state.

Out-of-tree ``Strategy`` subclasses that still override ``_optimize`` keep
working through the thread bridge, with this module's
``ProtocolDeprecationWarning``.

Port copy of ``src/repro/core/driver.py``
and kept as its own copy: the port imports nothing of ``repro``. Changes:
``drive_many(fuse="device")`` drives eligible runs through
``engine_torch.drive_fused`` on the torch engine (the reference's jax
engine). The thread bridge is the reference's, and keeps the device off
the bridge thread: that thread runs only the strategy's own loop (scipy,
``repair_x``) and hands each batch of configs over, so every
``run_batch``, and with it every ``commit_rows`` launch on the card, runs
on the driving thread; ``close()`` joins the thread. The port's
``ProtocolDeprecationWarning`` is a class of its own: pytest.ini escalates
only the reference's.
"""
from __future__ import annotations

import queue
import random
import threading
import warnings
from typing import Callable, Sequence

from .budget import BudgetExhausted
from .runner import Observation, Runner, run_fused
from .searchspace import SearchSpace
from .tunable import Config


class ProtocolDeprecationWarning(DeprecationWarning):
    """Raised-by-default in tier-1: a legacy ``_optimize`` body is being
    adapted through the thread bridge instead of speaking ask/tell."""


class FuseFallbackNotice(UserWarning):
    """A fused drive (device or host) fell back to a slower mode for some
    strategy. Informational, not an error: the fallback is bit-identical,
    only slower — but campaigns that silently degrade from the device path
    to sequential stepping cost orders of magnitude more wall time, so the
    reason is surfaced once per (strategy, reason) instead of never."""


_fuse_noticed: set = set()


def warn_fuse_fallback(strategy_name: str, reason: str, mode: str) -> None:
    """One-time (per process, per (strategy, reason)) notice that a fused
    drive degraded to ``mode`` (``"host"`` or ``"sequential"``)."""
    key = (strategy_name, reason)
    if key in _fuse_noticed:
        return
    _fuse_noticed.add(key)
    warnings.warn(
        f"{strategy_name}: fused drive falling back to {mode} stepping "
        f"({reason})", FuseFallbackNotice, stacklevel=3)


# --------------------------------------------------------------------- state
class SearchState:
    """Explicit per-run strategy state (the object ``ask``/``tell`` act on).

    Base fields: the search ``space``, the run's ``rng``, the ``finished``
    flag, and ``pending`` (configs asked but not yet told — ``None``
    between generations, which is when checkpoints are taken).

    Pickling drops the space (hub spaces may close over live caches) and
    every underscore-prefixed runtime attribute; ``bind(space)`` re-attaches
    the space on resume. Everything else — including the ``random.Random``
    — round-trips.
    """

    def __init__(self, space: SearchSpace, rng: random.Random):
        self.space = space
        self.rng = rng
        self.finished = False
        self.pending: Sequence[Config] | None = None

    # ------------------------------------------------------------ lifecycle
    def bind(self, space: SearchSpace) -> None:
        """Re-attach the (unpickled-away) search space before resuming."""
        self.space = space

    def attach_runner(self, runner: Runner) -> None:
        """Driver hook: bridges keep a transient runner reference so that
        proxied legacy code can still read ``runner.best``/``trace``."""

    def close(self) -> None:
        """Release runtime resources (generator frames, bridge threads)."""

    # -------------------------------------------------------------- pickling
    def __getstate__(self) -> dict:
        return {k: v for k, v in self.__dict__.items()
                if k != "space" and not k.startswith("_")}

    def __setstate__(self, d: dict) -> None:
        self.__dict__.update(d)
        self.space = None  # re-bound via bind()

    # ------------------------------------------------------------- protocol
    # Bridge states implement ask/tell themselves (the base Strategy
    # delegates here); native strategies override Strategy.ask/tell instead
    # and never call these.
    def ask(self) -> Sequence[Config] | None:
        raise NotImplementedError(
            f"{type(self).__name__} does not implement ask(); the strategy "
            "must override Strategy.ask/tell for this state type")

    def tell(self, observations: Sequence[Observation]) -> None:
        raise NotImplementedError


# ------------------------------------------------------------ replay bridges
class _ReplayBridgeState(SearchState):
    """Shared machinery for adapters whose runtime cannot pickle: serialize
    the initial RNG state plus the told-observation log, and rebuild the
    runtime by replaying it."""

    def __init__(self, strategy, space: SearchSpace, rng: random.Random):
        super().__init__(space, rng)
        self.strategy = strategy
        self.rng0 = rng.getstate()
        self.history: list[list[Observation]] = []

    # subclasses: create the runtime positioned at self.history's end and
    # set self.pending to the next asked batch (or finished)
    def _start(self) -> None:
        raise NotImplementedError

    def _running(self) -> bool:
        raise NotImplementedError

    def _advance(self, observations: list[Observation]) -> None:
        """Feed one observation batch to the runtime; update pending."""
        raise NotImplementedError

    def ask(self) -> Sequence[Config] | None:
        if self.finished:
            return None
        if not self._running():
            self._start()
            if self.finished:
                return None
        return self.pending

    def tell(self, observations: Sequence[Observation]) -> None:
        obs = list(observations)
        self.history.append(obs)
        self.pending = None
        self._advance(obs)


class GeneratorBridgeState(_ReplayBridgeState):
    """Adapter for strategies written as generators: ``_generate(space,
    rng)`` yields config batches and receives their observations back
    (``obs = yield [cfg]``). StopIteration means the strategy is done."""

    def _running(self) -> bool:
        return getattr(self, "_gen", None) is not None

    def _start(self) -> None:
        self.rng.setstate(self.rng0)
        self._gen = self.strategy._generate(self.space, self.rng)
        try:
            self.pending = next(self._gen)
            for obs in self.history:  # replay: reposition after unpickle
                self.pending = self._gen.send(obs)
        except StopIteration:
            self.finished = True
            self.pending = None

    def _advance(self, observations: list[Observation]) -> None:
        try:
            self.pending = self._gen.send(observations)
        except StopIteration:
            self.finished = True

    def close(self) -> None:
        gen = getattr(self, "_gen", None)
        if gen is not None:
            gen.close()
            self._gen = None


class _BridgeShutdown(BaseException):
    """Injected into a bridge thread to unwind it when the driver stops
    first (budget exhausted / driver closed). BaseException so legacy
    ``except Exception`` blocks cannot swallow it."""


class _ProxyRunner:
    """What a thread-bridged ``_optimize`` sees as its runner: evaluation
    calls rendezvous with the driver; everything else is delegated
    (read-only) to the real runner, which is only ever mutated while the
    strategy thread is blocked here."""

    def __init__(self, bridge: "_OptimizeThread"):
        self._bridge = bridge

    def run_batch(self, configs: Sequence[Config]) -> list[Observation]:
        bridge = self._bridge
        bridge.requests.put(("ask", list(configs)))
        resp = bridge.responses.get()
        if isinstance(resp, BaseException):
            raise resp
        return resp

    def run(self, config: Config) -> Observation:
        return self.run_batch([config])[0]

    def __call__(self, config: Config) -> float:
        return self.run_batch([config])[0].value

    def __getattr__(self, name: str):
        runner = self._bridge.runner
        if runner is None:
            raise AttributeError(
                f"proxy runner has no {name!r} (no live runner attached)")
        return getattr(runner, name)


class _OptimizeThread:
    """Daemon thread running a legacy imperative search loop, exchanging
    (ask, observations) pairs with the driver through one-shot queues."""

    def __init__(self, fn: Callable, space: SearchSpace, rng: random.Random,
                 runner: Runner | None):
        self.requests: queue.SimpleQueue = queue.SimpleQueue()
        self.responses: queue.SimpleQueue = queue.SimpleQueue()
        self.runner = runner
        self._thread = threading.Thread(
            target=self._main, args=(fn, space, rng), daemon=True,
            name="repro-bridge")
        self._thread.start()

    def _main(self, fn: Callable, space: SearchSpace,
              rng: random.Random) -> None:
        try:
            fn(space, _ProxyRunner(self), rng)
        except _BridgeShutdown:
            return
        except BaseException as e:  # surfaced on the driver side
            self.requests.put(("error", e))
            return
        self.requests.put(("done", None))

    def next_request(self):
        return self.requests.get()

    def respond(self, payload) -> None:
        self.responses.put(payload)

    def shutdown(self) -> None:
        # if the thread is (or will be) blocked awaiting a response, this
        # unwinds it; if it already finished, the token is never read
        self.responses.put(_BridgeShutdown())
        self._thread.join(timeout=10.0)


class ThreadBridgeState(_ReplayBridgeState):
    """Adapter for strategies that drive a foreign synchronous callback API
    (scipy's ``dual_annealing``): the legacy ``_optimize`` runs on a bridge
    thread; each of its runner calls becomes one ask/tell exchange."""

    def attach_runner(self, runner: Runner) -> None:
        self._runner = runner
        bridge = getattr(self, "_bridge", None)
        if bridge is not None:
            bridge.runner = runner

    def _running(self) -> bool:
        return getattr(self, "_bridge", None) is not None

    def _start(self) -> None:
        self.rng.setstate(self.rng0)
        self._bridge = _OptimizeThread(self.strategy._optimize, self.space,
                                       self.rng, getattr(self, "_runner", None))
        for obs in self.history:  # replay: reposition after unpickle
            kind, payload = self._bridge.next_request()
            if kind != "ask":
                raise RuntimeError(
                    f"bridge replay diverged: expected an evaluation "
                    f"request, got {kind!r} — the strategy is not "
                    f"deterministic given (rng, observations)")
            self._bridge.respond(obs)
        self._fetch()

    def _fetch(self) -> None:
        kind, payload = self._bridge.next_request()
        if kind == "ask":
            self.pending = payload
        elif kind == "done":
            self.finished = True
            self.pending = None
        else:  # "error": legacy loops propagate everything but the budget
            self.finished = True
            self.pending = None
            raise payload

    def _advance(self, observations: list[Observation]) -> None:
        self._bridge.respond(observations)
        self._fetch()

    def close(self) -> None:
        bridge = getattr(self, "_bridge", None)
        if bridge is not None:
            bridge.shutdown()
            self._bridge = None


def warn_legacy_optimize(strategy, stacklevel: int = 3) -> None:
    """The one copy of the legacy-``_optimize`` deprecation warning
    (``Strategy.run``'s direct dispatch and the thread-bridge fallback
    both emit it; tier-1 escalates it to an error unless asserted)."""
    warnings.warn(
        f"{type(strategy).__name__} only implements the legacy "
        f"_optimize(space, runner, rng) loop; implement init_state/ask/"
        f"tell (or _generate) for native ask/tell support — see "
        f"docs/api.md.",
        ProtocolDeprecationWarning, stacklevel=stacklevel)


def legacy_state(strategy, space: SearchSpace, rng: random.Random,
                 warn: bool = False) -> ThreadBridgeState:
    """Wrap an imperative ``_optimize`` body as a suspendable SearchState.

    Explicit callers (``dual_annealing``) opt in silently; the base
    ``Strategy.init_state`` fallback for out-of-tree subclasses warns."""
    if warn:
        warn_legacy_optimize(strategy, stacklevel=4)
    return ThreadBridgeState(strategy, space, rng)


# -------------------------------------------------------------------- driver
class SearchDriver:
    """Owns one tuning run: ask → evaluate (budget/trace) → tell.

    The runner keeps the observable run state (memo, budget, trace) exactly
    as before; the driver adds the loop, termination, and suspend/resume.
    """

    def __init__(self, strategy, space: SearchSpace, runner: Runner,
                 rng: random.Random | None = None,
                 state: SearchState | None = None):
        self.strategy = strategy
        self.runner = runner
        if state is None:
            if rng is None:
                raise ValueError("SearchDriver needs an rng or a state")
            state = strategy.init_state(space, rng)
        else:
            state.bind(space)
        self.state = state
        state.attach_runner(runner)
        self.exhausted = False
        # how this run's evaluations were driven: "sequential" (own
        # step()/run() loop) until a drive_many sets "host" or "device"
        self.fuse = "sequential"

    def step(self) -> bool:
        """One ask/evaluate/tell round; False when the run is over.

        ``BudgetExhausted`` from the runner ends the run *between* ask and
        tell — the strategy never observes a partially evaluated batch,
        matching where the legacy imperative loops stopped.
        """
        state = self.state
        if state.finished:
            return False
        configs = self.strategy.ask(state)
        if not configs:
            state.finished = True
            return False
        try:
            observations = self.runner.run_batch(configs)
        except BudgetExhausted:
            state.finished = True
            self.exhausted = True
            state.close()
            return False
        self.strategy.tell(state, observations)
        return True

    def run(self, checkpoint: Callable[["SearchDriver"], None] | None = None
            ) -> Observation | None:
        """Drive to completion; returns the best observation (None if no ok
        config was found). ``checkpoint`` fires after every completed
        generation (ask+tell round) with the driver — serialize
        ``snapshot()`` there to make the run suspendable."""
        try:
            while self.step():
                if checkpoint is not None:
                    checkpoint(self)
        finally:
            self.state.close()
        return self.runner.best

    # ------------------------------------------------------ suspend / resume
    def snapshot(self) -> dict:
        """Picklable mid-run checkpoint: strategy state + runner state."""
        return {"state": self.state, "runner": self.runner.state_dict()}

    @classmethod
    def resume(cls, strategy, space: SearchSpace, runner: Runner,
               snapshot: dict) -> "SearchDriver":
        """Rebuild a driver from ``snapshot()`` output: the runner (fresh,
        same budget limits and cache) is loaded with the checkpointed memo/
        trace/budget, and the strategy state is re-bound to ``space``."""
        runner.load_state_dict(snapshot["runner"])
        return cls(strategy, space, runner, state=snapshot["state"])


# ---------------------------------------------------------------- drive_many
def drive_many(drivers: Sequence[SearchDriver],
               engine: "str | None" = None,
               fuse: "str | None" = None) -> list[Observation | None]:
    """Interleave N tuning runs, fusing concurrent asks into shared batch
    resolutions (``runner.run_fused``) against the columnar engine.

    Each round every still-active driver asks once; asks whose runners
    share a cache resolve as one fused gather, then each driver is told its
    own observations. Per-run observable state is bit-identical to driving
    each run to completion on its own: runs share no mutable state beyond
    the (memoized, value-identical) space caches, and ``run_fused``
    preserves per-runner evaluation order exactly.

    ``engine`` overrides the row-resolution engine of every participating
    ``SimulationRunner`` for the drive (``"numpy"``/``"scalar"``/``"torch"``
    — see ``SimulationRunner``); observable per-run state is engine-
    independent because the torch replay path is bit-identical to numpy.
    A runner switched to ``"torch"`` keeps its ``device`` (the card when it
    had none).

    ``fuse`` selects the drive mechanism: ``"host"`` (default) is the
    per-round interleave above; ``"device"`` routes eligible runs — array-
    native strategies on torch-engine ``SimulationRunner``s — through the
    fused campaign executor (``engine_torch.campaign``: whole runs a
    budget-scan launch, bit-identical committed state) and drives the rest
    on the host after a one-time ``FuseFallbackNotice`` naming the
    strategy and reason. With no ``engine`` named, ``"device"`` switches
    every ``SimulationRunner`` to ``"torch"``, so without CUDA a runner
    that was not given ``device="cpu"`` raises. The chosen mode is
    recorded per driver as ``driver.fuse``.
    """
    if fuse not in (None, "host", "device"):
        raise ValueError(f"unknown fuse mode {fuse!r}; "
                         f"expected 'host' or 'device'")
    if engine is None and fuse == "device":
        engine = "torch"  # the device path is the torch engine's
    if engine is not None:
        from ..cuda import resolve_device
        from .runner import SimulationRunner
        if engine == "vectorized":
            engine = "numpy"
        if engine not in SimulationRunner.ENGINES:
            raise ValueError(f"unknown engine {engine!r}; expected one of "
                             f"{SimulationRunner.ENGINES}")
        for d in drivers:
            r = d.runner
            if isinstance(r, SimulationRunner):
                if engine == "torch":
                    r.device = resolve_device(r.device)
                r.engine = engine
    host_drivers: Sequence[SearchDriver] = drivers
    if fuse == "device":
        from . import engine_torch
        fused: list[SearchDriver] = []
        host_drivers = []
        for d in drivers:
            reason = engine_torch.fuse_reason(d)
            if reason is None:
                d.fuse = "device"
                fused.append(d)
            else:
                warn_fuse_fallback(
                    getattr(d.strategy, "name", type(d.strategy).__name__),
                    reason, "host")
                host_drivers.append(d)
        if fused:
            engine_torch.drive_fused(fused)
    for d in host_drivers:
        d.fuse = "host"
    active = [d for d in host_drivers if not d.state.finished]
    try:
        while active:
            batch: list[tuple[SearchDriver, list]] = []
            for d in active:
                configs = d.strategy.ask(d.state)
                if not configs:
                    d.state.finished = True
                    continue
                batch.append((d, configs))
            if not batch:
                break
            results = run_fused([(d.runner, configs)
                                 for d, configs in batch])
            survivors: list[SearchDriver] = []
            for (d, _configs), res in zip(batch, results):
                if isinstance(res, BudgetExhausted):
                    d.state.finished = True
                    d.exhausted = True
                    d.state.close()
                else:
                    d.strategy.tell(d.state, res)
                    survivors.append(d)
            active = survivors
    finally:
        for d in host_drivers:
            d.state.close()
    return [d.runner.best for d in drivers]

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

``GeneratorBridgeState`` converts an imperative search loop written as a
generator (``obs = yield configs``) into the protocol without rewriting it
as a state machine. A generator frame cannot pickle, so the state
serializes as a *replay log*: the RNG's initial state plus the sequence of
observation batches told so far. Unpickling re-runs the strategy's own
(cheap, deterministic) compute against the recorded observations — no
kernel evaluation is repeated — and lands it in the exact mid-run state.

Port copy of ``src/repro/core/driver.py``
and kept as its own copy: the port imports nothing of ``repro``. Changes:
``drive_many(fuse="device")`` (device-fused campaigns) raises
``NotImplementedError`` until its slice is ported; and the reference's
thread bridge for legacy ``_optimize`` loops (``ThreadBridgeState``, its
deprecation warning) and its ``FuseFallbackNotice`` are left out until a
slice ports a strategy that needs them (the port's registry holds only
ask/tell-native strategies).
"""
from __future__ import annotations

import random
from typing import Callable, Sequence

from .budget import BudgetExhausted
from .runner import Observation, Runner, run_fused
from .searchspace import SearchSpace
from .tunable import Config


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

    def close(self) -> None:
        """Release runtime resources (generator frames)."""

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
    per-round interleave above; ``"device"`` (the reference's
    device-resident campaign executor) is not ported yet and raises
    ``NotImplementedError``. The chosen mode is recorded per driver as
    ``driver.fuse``.
    """
    if fuse not in (None, "host", "device"):
        raise ValueError(f"unknown fuse mode {fuse!r}; "
                         f"expected 'host' or 'device'")
    if fuse == "device":
        raise NotImplementedError("fused device campaigns: later slice")
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

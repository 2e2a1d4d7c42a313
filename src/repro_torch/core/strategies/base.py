"""Strategy base class: the ask/tell protocol.

A strategy explores one SearchSpace until the budget is exhausted
(``BudgetExhausted`` from the runner) or its own termination criterion
fires. Strategies are pure-Python orchestration — every objective
evaluation goes through a runner, so live/simulated execution is
indistinguishable to the algorithm (paper Sec. III-E).

Since the ask/tell redesign a strategy is a *transition system* over an
explicit, picklable ``core.driver.SearchState``:

  * ``init_state(space, rng)`` builds the run's state;
  * ``ask(state)`` proposes the next batch of configs (``None``/empty when
    the strategy is done);
  * ``tell(state, observations)`` folds the batch's results back in.

The evaluate loop itself lives in ``core.driver.SearchDriver``; it owns
budget handling, trace recording, and the RNG stepping order.
``Strategy.run`` is a thin compatibility wrapper around the driver and is
bit-identical to the pre-refactor imperative loops (pinned by
tests/test_protocol.py against a frozen reference and recorded fixtures).

Two ways to implement a strategy:

  * natively (GA, PSO, DE, random search): override ``init_state``/``ask``/
    ``tell``;
  * as a generator (simulated annealing, the greedy local searches):
    subclass ``GeneratorStrategy`` and write ``_generate(space, rng)`` with
    ``obs = yield configs`` where the old loop called the runner.

Hyperparameters: each strategy declares ``DEFAULTS`` plus two hyperparameter
spaces — ``HYPERPARAM_SPACE`` (the paper's Table III, exhaustive-tuning sized)
and ``EXTENDED_SPACE`` (Table IV, meta-strategy sized). The hypertuner treats
these as ordinary SearchSpaces: tuning the tuner reuses the same machinery.

Port copy of ``src/repro/core/strategies/base.py``
and kept as its own copy: the port imports nothing of ``repro``. The
reference's third way, a legacy ``_optimize(space, runner, rng)`` loop
adapted through a thread bridge, is left out until a slice ports a
strategy that needs it (``dual_annealing``).
"""
from __future__ import annotations

import random
from typing import Mapping, Sequence

from ..driver import GeneratorBridgeState, SearchDriver, SearchState
from ..runner import Observation, Runner
from ..searchspace import SearchSpace
from ..tunable import Config

# Objective values can be inf (failed configs); strategies that do arithmetic
# on fitness use this finite stand-in.
FAILURE_FITNESS = 1e12


class Strategy:
    name: str = "base"
    DEFAULTS: dict = {}
    HYPERPARAM_SPACE: dict = {}
    EXTENDED_SPACE: dict = {}

    def __init__(self, **hyperparams):
        unknown = set(hyperparams) - set(self.DEFAULTS)
        if unknown:
            raise ValueError(f"{self.name}: unknown hyperparameters {sorted(unknown)}")
        self.hyperparams = {**self.DEFAULTS, **hyperparams}

    # ------------------------------------------------------ ask/tell protocol
    def init_state(self, space: SearchSpace, rng: random.Random) -> SearchState:
        """Build this run's explicit state; every strategy overrides this."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement init_state/ask/tell")

    def ask(self, state: SearchState) -> Sequence[Config] | None:
        """Next batch of configs to evaluate (None/empty = done). The base
        delegates to bridge states; native strategies override."""
        return state.ask()

    def tell(self, state: SearchState,
             observations: Sequence[Observation]) -> None:
        """Fold one evaluated batch (in ask order) back into the state."""
        state.tell(observations)

    # ------------------------------------------------------------ compat api
    def run(self, space: SearchSpace, runner: Runner,
            rng: random.Random) -> Observation | None:
        """Optimize; returns the best observation found (None if nothing ok).

        Thin wrapper over ``core.driver.SearchDriver`` — the runner records
        the full trace; callers read ``runner.trace``.
        """
        return SearchDriver(self, space, runner, rng).run()

    # ------------------------------------------------------------- helpers
    @staticmethod
    def fitness(value: float) -> float:
        return FAILURE_FITNESS if value == float("inf") else value

    def hp(self, key: str):
        return self.hyperparams[key]

    def __repr__(self):
        hp = ",".join(f"{k}={v}" for k, v in sorted(self.hyperparams.items()))
        return f"{self.name}({hp})"


class GeneratorStrategy(Strategy):
    """Base for strategies written as imperative generators.

    ``_generate(space, rng)`` yields batches of configs and receives their
    observations back: ``obs = yield [cfg]`` replaces the old
    ``runner(cfg)``. Returning (StopIteration) ends the run. State is a
    ``GeneratorBridgeState`` — suspendable via its replay log even though
    generator frames cannot pickle.
    """

    def init_state(self, space: SearchSpace,
                   rng: random.Random) -> SearchState:
        return GeneratorBridgeState(self, space, rng)

    def _generate(self, space: SearchSpace, rng: random.Random):
        raise NotImplementedError


def _escape_id(part) -> str:
    """Escape ``%``/``,``/``=`` so string-valued hyperparameters cannot
    collide in journal ids (e.g. ``{'a': '1,b=2'}`` vs ``{'a': 1, 'b': 2}``);
    ids of ordinary numeric/word values are unchanged."""
    s = str(part)
    if "%" in s or "," in s or "=" in s:
        s = s.replace("%", "%25").replace(",", "%2C").replace("=", "%3D")
    return s


def hyperparam_id(hp: Mapping) -> str:
    """Stable journal/ranking key for one hyperparameter configuration.

    Values containing the separator characters are escaped (see
    ``_escape_id``); journals written before the escaping existed resume
    cleanly because readers recompute ids from each record's stored
    ``hyperparams`` dict rather than trusting the stored id.
    """
    return ",".join(f"{_escape_id(k)}={_escape_id(hp[k])}" for k in sorted(hp))

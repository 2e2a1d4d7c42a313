"""Dual Annealing (paper Table III hyperparameters).

Wraps ``scipy.optimize.dual_annealing`` over the continuous index space, as
Kernel Tuner does. The single tuned hyperparameter is the local-search
``method`` (paper Table III: COBYLA, L-BFGS-B, SLSQP, CG, Powell,
Nelder-Mead, BFGS, trust-constr). Positions are rounded/repaired to valid
configs inside the objective; failures get a large finite penalty so the
numerical local phases stay well-defined.

scipy owns the control flow (it calls the objective synchronously), so this
strategy cannot be inverted into a native state machine; it opts into the
``core.driver`` thread bridge explicitly — the legacy ``_optimize`` loop
runs on a bridge thread and every objective call becomes one ask/tell
exchange. The run is still suspendable: the bridge state serializes as a
replay log (initial RNG state + observations told so far).

It is also the one strategy that stays on the value-tuple runner path
after the index-native refactor: scipy hands back float vectors one at a
time, so there is no batch to express as rows — but the objective's
round+repair now resolves through the compiled space's move tables
(``compiled.repair_x``), the former per-config scan-and-BFS hot spot.

Port copy of ``src/repro/core/strategies/dual_annealing.py``, code
unchanged (its imports are relative), and kept as its own copy: the port
imports nothing of ``repro``. Through the port's bridge the scipy loop
and the repair run on the bridge thread and every evaluation on the
driving thread (``core.driver``); either way each fresh config commits
as one ``commit_rows`` call at R = 1 on the torch engine.
"""
from __future__ import annotations

import random

import numpy as np
import scipy.optimize

from ..budget import BudgetExhausted
from ..driver import SearchState, legacy_state
from ..runner import Runner
from ..searchspace import SearchSpace
from .base import FAILURE_FITNESS, Strategy

METHODS = ("COBYLA", "L-BFGS-B", "SLSQP", "CG", "Powell", "Nelder-Mead",
           "BFGS", "trust-constr")


class DualAnnealing(Strategy):
    name = "dual_annealing"
    DEFAULTS = {"method": "Powell"}
    HYPERPARAM_SPACE = {"method": METHODS}
    EXTENDED_SPACE = {"method": METHODS}

    def init_state(self, space: SearchSpace,
                   rng: random.Random) -> SearchState:
        # explicit thread-bridge opt-in: no deprecation warning
        return legacy_state(self, space, rng)

    def _optimize(self, space: SearchSpace, runner: Runner, rng: random.Random) -> None:
        method = str(self.hp("method"))
        bounds = space.bounds
        # degenerate 1-value dims break scipy bounds; widen epsilon
        bounds = [(lo, hi if hi > lo else lo + 1e-6) for lo, hi in bounds]
        cs = space.compiled
        configs = cs.configs

        def objective(x: np.ndarray) -> float:
            # round+repair through the compiled move tables (bit-identical
            # to from_indices + nearest_valid, minus the per-call BFS)
            cfg = configs[cs.repair_x(x, rng)]
            v = runner(cfg)  # raises BudgetExhausted when spent
            return FAILURE_FITNESS if v == float("inf") else v

        while True:  # restart until the budget stops us
            try:
                scipy.optimize.dual_annealing(
                    objective, bounds,
                    minimizer_kwargs={"method": method},
                    seed=rng.getrandbits(32),
                    maxiter=1000,
                )
            except BudgetExhausted:
                raise
            except Exception:
                # some local methods can fail on the rounded landscape
                # (e.g. singular Hessian approximations) — restart
                continue

"""Simulated Annealing (paper Table III/IV hyperparameters).

Classic SA over the neighbor graph of the search space: accept worse moves
with probability exp(-Δrel / T); geometric cooling T ← α·T; restart from a
random config whenever T reaches T_min (budget permitting). Δrel is the
*relative* objective difference so that temperature values are comparable
across search spaces whose objectives differ by orders of magnitude.

Written as a generator (``GeneratorStrategy``): the walk reads exactly like
the pre-refactor imperative loop with each runner call replaced by a yield;
the generator bridge turns it into ask/tell and keeps the run suspendable
through its replay log.

Index-native: the walk lives entirely on compiled-space rows — neighbors
are one CSR slice per move and the yields are ``RowBatch``es, so no value
tuple or config-id string is ever built inside the loop. The rng stream is
unchanged (the neighbor pick indexes the same-length, same-order list the
scalar space produced).

Hyperparameters (matching the paper):
  T:        initial temperature            {0.5, 1.0, 1.5} / {0.1 … 2.0}
  T_min:    restart temperature            {1e-4, 1e-3, 1e-2} / {1e-4 … 0.1}
  alpha:    cooling rate                   {0.9925, 0.995, 0.9975}
  maxiter:  moves attempted per temperature {1, 2, 3} / {1 … 10}

Port copy of ``src/repro/core/strategies/simulated_annealing.py``,
code unchanged (its imports are relative), and kept as its own copy:
the port imports nothing of ``repro``.
"""
from __future__ import annotations

import math
import random

from ..searchspace import SearchSpace
from ..space import RowBatch
from .base import GeneratorStrategy


class SimulatedAnnealing(GeneratorStrategy):
    name = "simulated_annealing"
    DEFAULTS = {"T": 1.0, "T_min": 0.001, "alpha": 0.995, "maxiter": 2}
    HYPERPARAM_SPACE = {
        "T": (0.5, 1.0, 1.5),
        "T_min": (0.0001, 0.001, 0.01),
        "alpha": (0.9925, 0.995, 0.9975),
        "maxiter": (1, 2, 3),
    }
    EXTENDED_SPACE = {
        "T": tuple(round(0.1 * i, 1) for i in range(1, 21)),
        "T_min": tuple(round(0.0001 + 0.001 * i, 4) for i in range(100)),
        "alpha": (0.9925, 0.995, 0.9975),
        "maxiter": tuple(range(1, 11)),
    }

    def _generate(self, space: SearchSpace, rng: random.Random):
        T0 = float(self.hp("T"))
        T_min = float(self.hp("T_min"))
        alpha = float(self.hp("alpha"))
        maxiter = int(self.hp("maxiter"))
        cs = space.compiled

        while True:  # restart loop; terminated by BudgetExhausted
            current = cs.random_row(rng)
            f_cur = self.fitness((yield RowBatch(cs, (current,)))[0].value)
            T = T0
            while T > T_min:
                for _ in range(maxiter):
                    nbrs = cs.neighbors_rows(current)
                    if not len(nbrs):
                        current = cs.random_row(rng)
                        f_cur = self.fitness(
                            (yield RowBatch(cs, (current,)))[0].value)
                        continue
                    cand = int(nbrs[rng.randrange(len(nbrs))])
                    f_new = self.fitness(
                        (yield RowBatch(cs, (cand,)))[0].value)
                    d_rel = (f_new - f_cur) / max(abs(f_cur), 1e-30)
                    if d_rel <= 0 or rng.random() < math.exp(-d_rel / max(T, 1e-9)):
                        current, f_cur = cand, f_new
                T *= alpha

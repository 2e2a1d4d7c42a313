"""Additional strategies beyond the paper's four evaluated algorithms.

Kernel Tuner ships 20+ strategies (paper Table I); we implement four more
here so the hypertuner has a broader pool for meta-strategy experiments:
Differential Evolution, Basin Hopping, Greedy Iterated Local Search, and
Multi-start Local Search. Each declares hyperparameter spaces so they are
first-class citizens of the "tuning the tuner" pipeline.

DE is protocol-native (its generation stepping maps directly onto
ask/tell); the three local searches are generators (``GeneratorStrategy``):
imperative walks with each runner call replaced by a yield. GreedyILS and
MLS scan whole neighborhoods with best-improvement, so they yield the full
neighbor list as one batch (observably identical to the former per-neighbor
loop under the BatchRunner contract — and one vectorized gather on a
simulation runner); BasinHopping's descent is first-improvement and must
keep yielding one config at a time.

All four are index-native: walks live on compiled-space rows (whole
neighborhoods are CSR slices wrapped in ``RowBatch``es), perturbations
operate on value-index tuples, and repair runs over the precomputed move
tables — with every rng draw at the same stream position as the scalar
implementation.

Port copy of ``src/repro/core/strategies/extra.py``, code unchanged (its
imports are relative), and kept as its own copy: the port imports nothing
of ``repro``. On the torch engine DE runs device-fused
(``engine_torch.campaign.FUSED_STRATEGIES``); the three local searches
run on the host drive, each ask that holds a fresh row one
``commit_rows`` call.
"""
from __future__ import annotations

import math
import random

import numpy as np

from ..driver import SearchState
from ..searchspace import SearchSpace
from ..space import RowBatch
from .base import GeneratorStrategy, Strategy


class _DEState(SearchState):
    def __init__(self, space: SearchSpace, rng: random.Random):
        super().__init__(space, rng)
        # same rng-stream position as the pre-refactor loop's seeding draw
        self.np_rng = np.random.default_rng(rng.getrandbits(64))
        self.lo = np.zeros(len(space.tunables))
        self.hi = np.array([t.cardinality - 1 for t in space.tunables],
                           dtype=float)
        self.pop: np.ndarray | None = None  # None = (re)initialize on ask
        self.fit: np.ndarray | None = None  # None = initial batch pending
        self.i = 0    # member index (immediate updating)
        self.it = 0   # generation index
        self.asked: tuple | None = None  # (kind, trial(s), configs)


class DifferentialEvolution(Strategy):
    """DE/rand/1/bin over the continuous index space.

    ``updating`` controls selection semantics (mirrors scipy's
    ``differential_evolution``): ``"immediate"`` (default) updates the
    population member-by-member within a generation — each ask is a single
    trial, so later mutants see this generation's accepted trials (the
    original, order-dependent behaviour, bit-identical to the pre-refactor
    loop); ``"deferred"`` builds every trial vector from the generation's
    snapshot and asks the whole generation as one batch (one vectorized
    lookup on a simulation runner). It is a DEFAULTS-only knob, not part of
    ``HYPERPARAM_SPACE`` — adding it to the grid would change every
    exhaustive campaign's enumeration.
    """

    name = "differential_evolution"
    DEFAULTS = {"popsize": 20, "maxiter": 100, "F": 0.8, "CR": 0.9,
                "updating": "immediate"}
    HYPERPARAM_SPACE = {
        "popsize": (10, 20, 30),
        "maxiter": (50, 100, 150),
        "F": (0.4, 0.8, 1.2),
        "CR": (0.5, 0.7, 0.9),
    }
    EXTENDED_SPACE = {
        "popsize": tuple(range(4, 51, 2)),
        "maxiter": tuple(range(10, 201, 10)),
        "F": tuple(round(0.2 + 0.1 * i, 1) for i in range(15)),
        "CR": tuple(round(0.1 + 0.1 * i, 1) for i in range(9)),
    }

    def init_state(self, space: SearchSpace, rng: random.Random) -> _DEState:
        return _DEState(space, rng)

    def _make_trial(self, state: _DEState, i: int,
                    snapshot: np.ndarray) -> np.ndarray:
        popsize = max(4, int(self.hp("popsize")))
        F, CR = float(self.hp("F")), float(self.hp("CR"))
        np_rng = state.np_rng
        a, b, c = np_rng.choice(
            [j for j in range(popsize) if j != i], 3, replace=False)
        mutant = np.clip(snapshot[a] + F * (snapshot[b] - snapshot[c]),
                         state.lo, state.hi)
        cross = np_rng.uniform(size=len(state.lo)) < CR
        cross[np_rng.integers(len(state.lo))] = True
        return np.where(cross, mutant, snapshot[i])

    def ask(self, state: _DEState):
        rng = state.rng
        cs = state.space.compiled
        popsize = max(4, int(self.hp("popsize")))
        if state.pop is None:  # start / restart: fresh random population
            state.pop = np.stack([cs.x_of_row(cs.random_row(rng))
                                  for _ in range(popsize)])
            state.fit = None
            rows = cs.decode_rows(state.pop, rng)
            state.asked = ("init", None, rows)
            return RowBatch(cs, rows)
        if str(self.hp("updating")) == "deferred":
            # whole-generation ask: trials come from this generation's
            # snapshot, selection applies in tell
            trials = [self._make_trial(state, i, state.pop)
                      for i in range(popsize)]
            rows = cs.decode_rows(np.asarray(trials), rng)
            state.asked = ("deferred", trials, rows)
            return RowBatch(cs, rows)
        # immediate updating: one trial per ask, built against the current
        # (already part-updated) population
        trial = self._make_trial(state, state.i, state.pop)
        row = cs.repair_x(trial, rng)
        state.asked = ("immediate", trial, row)
        return RowBatch(cs, (row,))

    def tell(self, state: _DEState, observations) -> None:
        popsize = max(4, int(self.hp("popsize")))
        maxiter = int(self.hp("maxiter"))
        kind, trial, _cfgs = state.asked
        state.asked = None
        if kind == "init":
            state.fit = np.array([self.fitness(o.value)
                                  for o in observations])
            state.i = 0
            state.it = 0
            return
        if kind == "deferred":
            fs = [self.fitness(o.value) for o in observations]
            for i, (t, f) in enumerate(zip(trial, fs)):
                if f <= state.fit[i]:
                    state.pop[i], state.fit[i] = t, f
            state.it += 1
            if state.it >= maxiter:
                state.pop = None
            return
        f = self.fitness(observations[0].value)
        if f <= state.fit[state.i]:
            state.pop[state.i], state.fit[state.i] = trial, f
        state.i += 1
        if state.i >= popsize:
            state.i = 0
            state.it += 1
            if state.it >= maxiter:
                state.pop = None


class BasinHopping(GeneratorStrategy):
    name = "basin_hopping"
    DEFAULTS = {"T": 1.0, "stepsize": 2, "local_iters": 32}
    HYPERPARAM_SPACE = {
        "T": (0.5, 1.0, 1.5),
        "stepsize": (1, 2, 4),
        "local_iters": (16, 32, 64),
    }
    EXTENDED_SPACE = {
        "T": tuple(round(0.1 * i, 1) for i in range(1, 21)),
        "stepsize": (1, 2, 3, 4, 6, 8),
        "local_iters": (8, 16, 24, 32, 48, 64, 96, 128),
    }

    def _greedy_descent(self, start, cs, max_iters):
        # first-improvement: each neighbor must be observed before deciding
        # whether to evaluate the next, so this yields one row at a time
        cur = start
        f_cur = self.fitness((yield RowBatch(cs, (start,)))[0].value)
        for _ in range(max_iters):
            improved = False
            for n in cs.neighbors_rows(cur, strictly_adjacent=True).tolist():
                f = self.fitness((yield RowBatch(cs, (n,)))[0].value)
                if f < f_cur:
                    cur, f_cur, improved = n, f, True
                    break
            if not improved:
                break
        return cur, f_cur

    def _generate(self, space: SearchSpace, rng: random.Random):
        T = float(self.hp("T"))
        step = int(self.hp("stepsize"))
        local_iters = int(self.hp("local_iters"))
        cs = space.compiled
        cur, f_cur = yield from self._greedy_descent(
            cs.random_row(rng), cs, local_iters)
        while True:
            # hop: jump `step` positions in value-order on a few tunables
            jumped = list(cs.idx_tuples[cur])
            for i, card in enumerate(cs.cards):
                if rng.random() < 0.5:
                    j = jumped[i] + rng.choice((-step, step))
                    jumped[i] = max(0, min(card - 1, j))
            start = cs.repair_vidx(tuple(jumped), rng)
            cand, f_cand = yield from self._greedy_descent(start, cs,
                                                           local_iters)
            d_rel = (f_cand - f_cur) / max(abs(f_cur), 1e-30)
            if d_rel <= 0 or rng.random() < math.exp(-d_rel / max(T, 1e-9)):
                cur, f_cur = cand, f_cand


class GreedyILS(GeneratorStrategy):
    name = "greedy_ils"
    DEFAULTS = {"perturbation": 2, "restart_chance": 0.05}
    HYPERPARAM_SPACE = {
        "perturbation": (1, 2, 4),
        "restart_chance": (0.0, 0.05, 0.2),
    }
    EXTENDED_SPACE = {
        "perturbation": (1, 2, 3, 4, 6, 8),
        "restart_chance": (0.0, 0.01, 0.02, 0.05, 0.1, 0.2, 0.4),
    }

    def _generate(self, space: SearchSpace, rng: random.Random):
        k = int(self.hp("perturbation"))
        p_restart = float(self.hp("restart_chance"))
        cs = space.compiled
        cur = cs.random_row(rng)
        f_cur = self.fitness((yield RowBatch(cs, (cur,)))[0].value)
        while True:
            # greedy descent to local optimum (best-improvement: the whole
            # neighborhood is one ask — one CSR slice, one row gather)
            while True:
                nbrs = cs.neighbors_rows(cur)
                best_n, best_f = None, f_cur
                if len(nbrs):
                    obs = yield RowBatch(cs, nbrs)
                    for n, o in zip(nbrs.tolist(), obs):
                        f = self.fitness(o.value)
                        if f < best_f:
                            best_n, best_f = n, f
                if best_n is None:
                    break
                cur, f_cur = best_n, best_f
            # perturb k random tunables (or restart)
            if rng.random() < p_restart:
                cur = cs.random_row(rng)
            else:
                out = list(cs.idx_tuples[cur])
                idxs = rng.sample(range(cs.n_tunables),
                                  min(k, cs.n_tunables))
                for i in idxs:
                    out[i] = rng.randrange(cs.cards[i])
                cur = cs.repair_vidx(tuple(out), rng)
            f_cur = self.fitness((yield RowBatch(cs, (cur,)))[0].value)


class MultiStartLocalSearch(GeneratorStrategy):
    name = "mls"
    DEFAULTS = {"adjacent_only": True}
    HYPERPARAM_SPACE = {"adjacent_only": (True, False)}
    EXTENDED_SPACE = {"adjacent_only": (True, False)}

    def _generate(self, space: SearchSpace, rng: random.Random):
        adjacent = bool(self.hp("adjacent_only"))
        cs = space.compiled
        while True:
            cur = cs.random_row(rng)
            f_cur = self.fitness((yield RowBatch(cs, (cur,)))[0].value)
            while True:
                nbrs = cs.neighbors_rows(cur, strictly_adjacent=adjacent)
                best_n, best_f = None, f_cur
                if len(nbrs):
                    obs = yield RowBatch(cs, nbrs)
                    for n, o in zip(nbrs.tolist(), obs):
                        f = self.fitness(o.value)
                        if f < best_f:
                            best_n, best_f = n, f
                if best_n is None:
                    break
                cur, f_cur = best_n, best_f

"""Particle Swarm Optimization (paper Table III/IV hyperparameters).

Standard PSO over the continuous index space of the tunables; positions are
rounded to configs (repaired when invalid) for evaluation. The paper found
the inertia ``w`` to have no meaningful effect (Kruskal-Wallis / mutual
information sensitivity test, Sec. IV-A) and excludes it from tuning; it
remains available as a hyperparameter with its Kernel Tuner default.

Protocol-native: ``ask`` decodes the swarm's positions to one config batch
(initializing positions/velocities at start and after each restart);
``tell`` updates personal/global bests and steps velocities. Decode repairs
draw from the run RNG in ask and velocity updates draw from the numpy
generator in tell — the same interleaving as the pre-refactor loop, so
traces are bit-identical.

Index-native: positions decode to compiled-space *rows*
(``compiled.decode_rows``: one whole-matrix round/clip, repair through the
move tables), the ask is a ``RowBatch``, and best-position reads come
straight from the value-index matrix (``x_of_row`` == the old
``to_indices`` of the decoded config).

Hyperparameters:
  popsize: swarm size                {10, 20, 30} / {2 … 50}
  maxiter: iterations                {50, 100, 150} / {10 … 200}
  c1:      cognitive coefficient     {1.0, 2.0, 3.0} / {1.0 … 3.5}
  c2:      social coefficient        {0.5, 1.0, 1.5} / {0.5 … 2.0}
  w:       inertia (not tuned)       default 0.5

Port copy of ``src/repro/core/strategies/particle_swarm.py``,
code unchanged (its imports are relative), and kept as its own copy:
the port imports nothing of ``repro``.
"""
from __future__ import annotations

import random

import numpy as np

from ..driver import SearchState
from ..searchspace import SearchSpace
from ..space import RowBatch
from .base import Strategy


class _PSOState(SearchState):
    def __init__(self, space: SearchSpace, rng: random.Random):
        super().__init__(space, rng)
        # drawn here — at the same point in the rng stream as the
        # pre-refactor loop drew it (top of _optimize)
        self.np_rng = np.random.default_rng(rng.getrandbits(64))
        self.lo = np.zeros(len(space.tunables))
        self.hi = np.array([t.cardinality - 1 for t in space.tunables],
                           dtype=float)
        self.span = np.maximum(self.hi - self.lo, 1.0)
        self.pos: np.ndarray | None = None  # None = (re)initialize on ask
        self.vel = self.pbest = self.pbest_f = self.gbest = None
        self.gbest_f = np.inf
        self.it = 0
        self.asked: np.ndarray | None = None  # decoded rows of the open ask


class ParticleSwarm(Strategy):
    name = "pso"
    DEFAULTS = {"popsize": 20, "maxiter": 100, "c1": 2.0, "c2": 1.0, "w": 0.5}
    HYPERPARAM_SPACE = {
        "popsize": (10, 20, 30),
        "maxiter": (50, 100, 150),
        "c1": (1.0, 2.0, 3.0),
        "c2": (0.5, 1.0, 1.5),
    }
    EXTENDED_SPACE = {
        "popsize": tuple(range(2, 51, 2)),
        "maxiter": tuple(range(10, 201, 10)),
        "c1": tuple(round(1.0 + 0.25 * i, 2) for i in range(11)),
        "c2": tuple(round(0.5 + 0.25 * i, 2) for i in range(7)),
    }

    def init_state(self, space: SearchSpace, rng: random.Random) -> _PSOState:
        return _PSOState(space, rng)

    def ask(self, state: _PSOState):
        rng = state.rng
        cs = state.space.compiled
        if state.pos is None:  # start / post-restart initialization
            popsize = int(self.hp("popsize"))
            state.pos = np.stack([cs.x_of_row(cs.random_row(rng))
                                  for _ in range(popsize)])
            state.vel = (state.np_rng.uniform(-1, 1, state.pos.shape)
                         * state.span * 0.25)
            state.pbest = state.pos.copy()
            state.pbest_f = np.full(popsize, np.inf)
            state.gbest, state.gbest_f = state.pos[0].copy(), np.inf
            state.it = 0
        # decode + repair the whole swarm in one vectorized call (repairs
        # draw from rng exactly as the per-particle loop did)
        state.asked = cs.decode_rows(state.pos, rng)
        return RowBatch(cs, state.asked)

    def tell(self, state: _PSOState, observations) -> None:
        cs = state.space.compiled
        c1, c2 = float(self.hp("c1")), float(self.hp("c2"))
        w = float(self.hp("w"))
        for i, (o, row) in enumerate(zip(observations,
                                         state.asked.tolist())):
            f = self.fitness(o.value)
            if f < state.pbest_f[i]:
                state.pbest_f[i] = f
                state.pbest[i] = cs.x_of_row(row)
            if f < state.gbest_f:
                state.gbest_f = f
                state.gbest = cs.x_of_row(row)
        state.asked = None
        np_rng, pos = state.np_rng, state.pos
        r1 = np_rng.uniform(size=pos.shape)
        r2 = np_rng.uniform(size=pos.shape)
        vel = (w * state.vel + c1 * r1 * (state.pbest - pos)
               + c2 * r2 * (state.gbest - pos))
        vel = np.clip(vel, -state.span, state.span)
        state.vel = vel
        state.pos = np.clip(pos + vel, state.lo, state.hi)
        state.it += 1
        if state.it >= int(self.hp("maxiter")):
            state.pos = None  # restart from fresh random positions

"""Genetic Algorithm (paper Table III/IV hyperparameters).

Rank-weighted parent selection, four crossover methods matching Kernel
Tuner's (single_point, two_point, uniform, disruptive_uniform), per-gene
mutation with probability 1/mutation_chance, invalid children repaired to the
nearest valid config.

Protocol-native: ``ask`` returns the current population (drawing a fresh
random one at start and after every ``maxiter``-generation restart),
``tell`` breeds the next one. The RNG draw order — breeding draws in tell,
(re)initialization draws in the following ask — interleaves with
evaluations exactly as the pre-refactor loop did, so traces are
bit-identical.

Index-native: genomes are value-*index* tuples of the compiled space.
Crossover and mutation are generic tuple operations, so they work
unchanged on indices (equality per gene is preserved — value<->index is a
bijection per tunable), mutation draws the same ``randrange(cardinality)``,
and repair runs over the precomputed move tables. ``ask`` gathers the
population's rows in one vectorized lookup and hands the runner a
``RowBatch``.

Hyperparameters:
  method:          crossover operator
  popsize:         population size           {10, 20, 30} / {2 … 50}
  maxiter:         number of generations     {50, 100, 150} / {10 … 200}
  mutation_chance: inverse mutation rate     {5, 10, 20} / {5 … 100}

Port copy of ``src/repro/core/strategies/genetic_algorithm.py``
and kept as its own copy: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import random

from ..driver import SearchState
from ..searchspace import SearchSpace
from ..space import CompiledSpace, RowBatch
from .base import Strategy


def _single_point(a: tuple, b: tuple, rng: random.Random) -> tuple:
    if len(a) < 2:
        return a, b
    p = rng.randrange(1, len(a))
    return a[:p] + b[p:], b[:p] + a[p:]


def _two_point(a: tuple, b: tuple, rng: random.Random) -> tuple:
    if len(a) < 3:
        return _single_point(a, b, rng)
    p, q = sorted(rng.sample(range(1, len(a)), 2))
    return (a[:p] + b[p:q] + a[q:], b[:p] + a[p:q] + b[q:])


def _uniform(a: tuple, b: tuple, rng: random.Random) -> tuple:
    c1, c2 = list(a), list(b)
    for i in range(len(a)):
        if rng.random() < 0.5:
            c1[i], c2[i] = c2[i], c1[i]
    return tuple(c1), tuple(c2)


def _disruptive_uniform(a: tuple, b: tuple, rng: random.Random) -> tuple:
    """Swap *every* differing gene with p=0.5 but guarantee at least half of
    the differing genes swap (Kernel Tuner's disruptive variant: maximizes
    mixing of dissimilar parents)."""
    diff = [i for i in range(len(a)) if a[i] != b[i]]
    rng.shuffle(diff)
    k = max((len(diff) + 1) // 2, min(1, len(diff)))
    c1, c2 = list(a), list(b)
    for i in diff[:k]:
        c1[i], c2[i] = c2[i], c1[i]
    return tuple(c1), tuple(c2)


CROSSOVERS = {
    "single_point": _single_point,
    "two_point": _two_point,
    "uniform": _uniform,
    "disruptive_uniform": _disruptive_uniform,
}


class _GAState(SearchState):
    def __init__(self, space: SearchSpace, rng: random.Random):
        super().__init__(space, rng)
        self.pop: list | None = None  # index-tuple genomes; None = restart
        self.gen = 0


class GeneticAlgorithm(Strategy):
    name = "genetic_algorithm"
    DEFAULTS = {"method": "uniform", "popsize": 20, "maxiter": 100,
                "mutation_chance": 10}
    HYPERPARAM_SPACE = {
        "method": tuple(CROSSOVERS),
        "popsize": (10, 20, 30),
        "maxiter": (50, 100, 150),
        "mutation_chance": (5, 10, 20),
    }
    EXTENDED_SPACE = {
        "method": tuple(CROSSOVERS),
        "popsize": tuple(range(2, 51, 2)),
        "maxiter": tuple(range(10, 201, 10)),
        "mutation_chance": tuple(range(5, 101, 5)),
    }

    def init_state(self, space: SearchSpace, rng: random.Random) -> _GAState:
        return _GAState(space, rng)

    def ask(self, state: _GAState):
        cs = state.space.compiled
        if state.pop is None:
            popsize = int(self.hp("popsize"))
            idx_tab = cs.idx_tuples
            state.pop = [idx_tab[cs.random_row(state.rng)]
                         for _ in range(popsize)]
            state.gen = 0
        # the whole generation is evaluated in one batch (one vectorized
        # row gather on a simulation runner); population order is
        # preserved, so the trace — and every downstream score — matches
        # the former one-config-at-a-time loop
        return RowBatch(cs, cs.rows_of_vidx(state.pop))

    def tell(self, state: _GAState, observations) -> None:
        popsize = int(self.hp("popsize"))
        generations = int(self.hp("maxiter"))
        p_mut = 1.0 / float(self.hp("mutation_chance"))
        crossover = CROSSOVERS[str(self.hp("method"))]
        rng, pop = state.rng, state.pop
        cs = state.space.compiled

        scored = sorted(((self.fitness(o.value), i, c)
                         for i, (o, c) in enumerate(zip(observations, pop))),
                        key=lambda t: (t[0], t[1]))
        ranked = [c for _, _, c in scored]
        # rank weights: best gets weight popsize, worst gets 1
        weights = list(range(popsize, 0, -1))
        children: list[tuple] = [ranked[0]]  # elitism: keep the best
        while len(children) < popsize:
            a, b = rng.choices(ranked, weights=weights, k=2)
            c1, c2 = crossover(a, b, rng)
            for child in (c1, c2):
                child = self._mutate(child, cs, rng, p_mut)
                child = cs.idx_tuples[cs.repair_vidx(child, rng)]
                children.append(child)
                if len(children) >= popsize:
                    break
        state.gen += 1
        if state.gen >= generations:
            # restart: the bred children are discarded and the next ask
            # draws a fresh random population — the same draws, in the same
            # order, as the pre-refactor restart loop
            state.pop = None
        else:
            state.pop = children

    @staticmethod
    def _mutate(genome: tuple, cs: CompiledSpace, rng: random.Random,
                p_mut: float) -> tuple:
        out = list(genome)
        for i, card in enumerate(cs.cards):
            if rng.random() < p_mut:
                out[i] = rng.randrange(card)
        return tuple(out)

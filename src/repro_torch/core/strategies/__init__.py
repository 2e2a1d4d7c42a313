"""Strategy registry.

The four paper-evaluated algorithms (Table III/IV) plus random search (the
methodology baseline) and four extra strategies. ``get_strategy`` builds a
configured instance; ``PAPER_STRATEGIES`` is the evaluation set of Sec. IV.

Port copy of ``src/repro/core/strategies/__init__.py``, code unchanged
(its imports are relative), and kept as its own copy: the port imports
nothing of ``repro``.
"""
from __future__ import annotations

from .base import GeneratorStrategy, Strategy, hyperparam_id
from .dual_annealing import DualAnnealing
from .extra import (BasinHopping, DifferentialEvolution, GreedyILS,
                    MultiStartLocalSearch)
from .genetic_algorithm import GeneticAlgorithm
from .particle_swarm import ParticleSwarm
from .random_search import RandomSearch
from .simulated_annealing import SimulatedAnnealing

STRATEGIES: dict[str, type[Strategy]] = {
    cls.name: cls
    for cls in (
        RandomSearch,
        SimulatedAnnealing,
        DualAnnealing,
        GeneticAlgorithm,
        ParticleSwarm,
        DifferentialEvolution,
        BasinHopping,
        GreedyILS,
        MultiStartLocalSearch,
    )
}

# The algorithms evaluated in the paper (Sec. IV-A, Table III).
PAPER_STRATEGIES = ("dual_annealing", "genetic_algorithm", "pso",
                    "simulated_annealing")


def get_strategy(name: str, **hyperparams) -> Strategy:
    try:
        cls = STRATEGIES[name]
    except KeyError:
        raise KeyError(f"unknown strategy {name!r}; known: {sorted(STRATEGIES)}")
    return cls(**hyperparams)


__all__ = ["Strategy", "GeneratorStrategy", "STRATEGIES", "PAPER_STRATEGIES",
           "get_strategy", "hyperparam_id", "RandomSearch", "SimulatedAnnealing",
           "DualAnnealing", "GeneticAlgorithm", "ParticleSwarm",
           "DifferentialEvolution", "BasinHopping", "GreedyILS",
           "MultiStartLocalSearch"]

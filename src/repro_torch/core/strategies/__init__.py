"""Strategy registry of the port.

Port of ``src/repro/core/strategies/__init__.py``, holding the strategies
ported so far: random search (the methodology's baseline), and three of
the paper's four tuned algorithms, the genetic algorithm, simulated
annealing and particle swarm optimization. ``get_strategy`` raises
``KeyError`` for the reference's other strategies, as for any unknown
name; ROADMAP.md queues them. ``PAPER_STRATEGIES`` waits for dual
annealing, the fourth.
"""
from __future__ import annotations

from .base import GeneratorStrategy, Strategy, hyperparam_id
from .genetic_algorithm import GeneticAlgorithm
from .particle_swarm import ParticleSwarm
from .random_search import RandomSearch
from .simulated_annealing import SimulatedAnnealing

STRATEGIES: dict[str, type[Strategy]] = {
    cls.name: cls
    for cls in (RandomSearch, SimulatedAnnealing, GeneticAlgorithm,
                ParticleSwarm)
}


def get_strategy(name: str, **hyperparams) -> Strategy:
    try:
        cls = STRATEGIES[name]
    except KeyError:
        raise KeyError(f"unknown strategy {name!r}; known: {sorted(STRATEGIES)}")
    return cls(**hyperparams)


__all__ = ["Strategy", "GeneratorStrategy", "STRATEGIES", "get_strategy",
           "hyperparam_id", "RandomSearch", "SimulatedAnnealing",
           "GeneticAlgorithm", "ParticleSwarm"]

"""Strategy registry of the port.

Port of ``src/repro/core/strategies/__init__.py``, holding the two
strategies of this slice: random search (the methodology's baseline) and
the genetic algorithm. ``get_strategy`` raises ``KeyError`` for the
reference's other strategies, as for any unknown name; ROADMAP.md queues
them.
"""
from __future__ import annotations

from .base import GeneratorStrategy, Strategy, hyperparam_id
from .genetic_algorithm import GeneticAlgorithm
from .random_search import RandomSearch

STRATEGIES: dict[str, type[Strategy]] = {
    cls.name: cls for cls in (RandomSearch, GeneticAlgorithm)
}


def get_strategy(name: str, **hyperparams) -> Strategy:
    try:
        cls = STRATEGIES[name]
    except KeyError:
        raise KeyError(f"unknown strategy {name!r}; known: {sorted(STRATEGIES)}")
    return cls(**hyperparams)


__all__ = ["Strategy", "GeneratorStrategy", "STRATEGIES", "get_strategy",
           "hyperparam_id", "RandomSearch", "GeneticAlgorithm"]

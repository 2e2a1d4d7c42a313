"""Budget accounting in *simulated* time (paper Sec. III-C/E).

All strategies spend a budget of simulated seconds: each fresh evaluation of a
kernel configuration charges its recorded/modelled compile + run (+ framework
overhead) time, exactly as if the tuning run were live. Revisited
configurations are served from the tuner-side memo and charge nothing, matching
Kernel Tuner's cache behaviour that the paper's simulation-mode cost analysis
relies on ("configurations are likely to be revisited").

``BudgetExhausted`` is raised by the runner when the budget is spent; strategies
treat it as the stop signal.

Port copy of ``src/repro/core/budget.py``
and kept as its own copy: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import dataclasses


class BudgetExhausted(Exception):
    pass


@dataclasses.dataclass
class Budget:
    """Simulated-time and/or evaluation-count budget."""

    max_seconds: float | None = None
    max_evals: int | None = None
    spent_seconds: float = 0.0
    spent_evals: int = 0

    def charge(self, seconds: float, evals: int = 1) -> None:
        self.spent_seconds += float(seconds)
        self.spent_evals += int(evals)

    @property
    def exhausted(self) -> bool:
        if self.max_seconds is not None and self.spent_seconds >= self.max_seconds:
            return True
        if self.max_evals is not None and self.spent_evals >= self.max_evals:
            return True
        return False

    def check(self) -> None:
        if self.exhausted:
            raise BudgetExhausted(
                f"spent {self.spent_seconds:.3f}s/{self.max_seconds}s, "
                f"{self.spent_evals}/{self.max_evals} evals")

    def copy_empty(self) -> "Budget":
        return Budget(max_seconds=self.max_seconds, max_evals=self.max_evals)

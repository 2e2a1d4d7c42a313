"""Tunable parameters and constraints for auto-tuning search spaces.

This mirrors the paper's setting (Sec. III-A): a search space ``X`` is the
Cartesian product of tunable parameters' value sets, filtered by user-defined
constraints (``restrictions`` in Kernel Tuner terminology).

A configuration is represented as an immutable ``tuple`` of values in the
order the tunables were declared; dict views are provided for readability.

Port copy of ``src/repro/core/tunable.py``
and kept as its own copy: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Mapping, Sequence

Value = Any
Config = tuple  # tuple of values, one per tunable, in declaration order


@dataclasses.dataclass(frozen=True)
class Tunable:
    """One tunable parameter with its finite, ordered value set.

    ``values`` must be non-empty and free of duplicates. Order matters: local
    search strategies treat adjacent values as neighbors (the usual treatment
    of numerical parameters in auto-tuning).
    """

    name: str
    values: tuple

    def __post_init__(self):
        if not self.values:
            raise ValueError(f"tunable {self.name!r} has no values")
        if len(set(self.values)) != len(self.values):
            raise ValueError(f"tunable {self.name!r} has duplicate values")

    @property
    def cardinality(self) -> int:
        return len(self.values)

    @functools.cached_property
    def position(self) -> dict:
        """value -> index table; the O(1) core of ``index_of`` and of the
        compiled-space row lookups (``core.space``). First declaration wins
        like ``list.index`` (equal-hashing values such as ``1``/``1.0`` are
        already rejected as duplicates by ``__post_init__``, so this is
        belt-and-braces, not a reachable branch)."""
        table: dict = {}
        for i, v in enumerate(self.values):
            table.setdefault(v, i)
        return table

    @functools.cached_property
    def _by_str(self) -> dict:
        """str(value) -> value. First declaration wins on str collisions
        (e.g. ``1`` vs ``"1"``), matching the original linear scan."""
        table: dict = {}
        for v in self.values:
            table.setdefault(str(v), v)
        return table

    def index_of(self, value: Value) -> int:
        pos = self.position.get(value)
        if pos is None:
            # keep the canonical ValueError of the original list scan
            return self.values.index(value)
        return pos

    def from_str(self, s: str) -> Value:
        """The value whose ``str()`` is ``s`` (first match in declaration
        order). Replaces the O(cardinality) scan ``config_from_id`` used to
        do per serialized value — it is called per record on journal resume
        and cache merge."""
        try:
            return self._by_str[s]
        except KeyError:
            raise KeyError(f"{s!r} not a value of {self.name!r}") from None


@dataclasses.dataclass(frozen=True)
class Constraint:
    """A predicate over a configuration dict; False ⇒ config is invalid.

    ``fn`` receives a mapping {tunable_name: value}. ``description`` is used
    in the T1-format dataset export.
    """

    fn: Callable[[Mapping[str, Value]], bool]
    description: str = ""

    def __call__(self, conf: Mapping[str, Value]) -> bool:
        return bool(self.fn(conf))


def tunables_from_dict(d: Mapping[str, Sequence[Value]]) -> tuple:
    """Convenience: build Tunables from an ordered {name: values} mapping."""
    return tuple(Tunable(name, tuple(vals)) for name, vals in d.items())

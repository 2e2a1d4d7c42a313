"""Compiled, array-backed search spaces (the index-native core).

A ``SearchSpace`` (``core.searchspace``, now a thin facade) compiles once
into a :class:`CompiledSpace`: a validity bitmap over the Cartesian
product, a ``(n_valid, n_tunables)`` value-index matrix, CSR neighbor
tables for both neighbor semantics, and single-move repair tables. Integer
row indices are the native config representation through the whole
simulation hot path — value tuples and config-id strings materialize only
at the API / recording / journal serialization boundary.

Module map:
  compile.py    blocked vectorized enumeration -> CompiledSpace
  compiled.py   the array-backed space: row-native queries
  neighbors.py  CSR neighbor-table construction (both semantics)
  repair.py     nearest-valid repair: move tables + flat-index BFS
  rows.py       RowBatch — integer config batches that materialize value
                tuples lazily (so non-simulation runners keep working)

Port copy of ``src/repro/core/space/__init__.py``
and kept as its own copy: the port imports nothing of ``repro``. The
port keeps its own copy of ``reference.py``, the frozen scalar oracle the
compiled space is pinned against (not part of the port's path).
"""
from .compile import compile_space
from .compiled import CompiledSpace
from .rows import RowBatch

__all__ = ["CompiledSpace", "RowBatch", "compile_space"]

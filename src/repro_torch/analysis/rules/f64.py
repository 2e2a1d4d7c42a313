"""float64 budget-discipline rules for the card's engine.

Replay is bit-exact because budget spend accumulates left-to-right in
float64 (``core/engine_torch/csrc/budget_scan.cu`` and its plain version
``replay.budget_scan_plain``; the module docstring of ``replay.py`` is
explicit that any parallel scan reassociates the additions and drifts by
ULPs). Statically enforceable corollaries for everything under
``core/engine_torch/``:

  * no ``torch.cumsum``/``cumprod``/``logcumsumexp`` — parallel scans
    reassociate; sequential accumulation goes through the budget scan;
  * no float32 dtypes or casts — the tables are float64 mirrors of the
    cache columns, and a float32 intermediate silently truncates them;
  * reductions spell out their dtype — the accumulator of a reduction is
    part of the result, so it is written where the reduction is.

Port copy of ``src/repro/analysis/rules/f64.py``. Changed, for the port's
library and device: the scope is ``core/engine_torch/``; the banned scans
are torch's (``numpy.cumsum`` stays the sequential host reference); the
reduction rule reads ``torch.sum``/``torch.prod``/``torch.nansum`` and
the ``.sum()``/``.prod()``/``.nansum()`` methods without ``dtype=``; the
float32 rule reads ``torch.float32``, its alias ``torch.float`` and the
``.float()`` cast, beside ``np.float32`` and ``dtype="float32"``.
"""
from __future__ import annotations

import ast

from ..core import ERROR, WARNING, Rule, call_name, dotted

_TORCH_ROOTS = ("torch",)
_SCOPE = ("core/engine_torch/",)
_REDUCTIONS = ("sum", "prod", "nansum")


def _torch_call(node: ast.Call, names: tuple) -> str | None:
    full = call_name(node)
    if full is None:
        return None
    for root in _TORCH_ROOTS:
        for fn in names:
            if full == f"{root}.{fn}":
                return fn
    return None


def _has_kwarg(node: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in node.keywords)


class ParallelScanOnDevice(Rule):
    name = "f64-parallel-scan"
    severity = ERROR
    scope = _SCOPE
    invariant = ("budget/spend accumulation is left-to-right float64 "
                 "through the budget scan; parallel prefix scans "
                 "reassociate and drift")
    oracle = ("the budget scan bit-identical to the numpy engine, "
              "exhaustion points included (tests/test_torch_replay.py)")

    def visit_Call(self, ctx, node):
        fn = _torch_call(node, ("cumsum", "cumprod", "logcumsumexp"))
        if fn is not None:
            yield self.finding(
                ctx, node,
                f"{call_name(node)}() is a parallel scan — it reassociates "
                f"float additions and breaks bit-parity with the "
                f"sequential numpy accumulation; use the budget scan")


class ReductionWithoutDtype(Rule):
    name = "f64-sum-dtype"
    severity = WARNING
    scope = _SCOPE
    invariant = ("device reductions pin their accumulator dtype where "
                 "they are written")
    oracle = ("float64 tables and int64 counters asserted by the engine "
              "tests (tests/test_torch_replay.py, "
              "tests/test_torch_free_run.py)")

    def visit_Call(self, ctx, node):
        fn = _torch_call(node, _REDUCTIONS)
        if fn is None and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _REDUCTIONS \
                and dotted(node.func.value) not in ("torch", "np", "numpy"):
            fn = node.func.attr
        if fn is not None and not _has_kwarg(node, "dtype"):
            yield self.finding(
                ctx, node,
                f"{fn}() without an explicit dtype= — pin the "
                f"accumulator where the reduction is written "
                f"(dtype=torch.float64 for budget/spend, torch.int64 for "
                f"counters)")


class Float32Literal(Rule):
    name = "f64-float32-literal"
    severity = ERROR
    scope = _SCOPE
    invariant = ("the replay tables and commit path are float64 "
                 "end-to-end; a float32 cast silently truncates the "
                 "cache's charge/time columns")
    oracle = ("float64 device mirrors asserted by the table tests "
              "(tests/test_torch_replay.py) + replay bit-parity tests")

    _NAMES = ("torch.float32", "torch.float", "np.float32",
              "numpy.float32")

    def visit_Attribute(self, ctx, node):
        if node.attr not in ("float32", "float"):
            return
        name = dotted(node)
        if name in self._NAMES:
            yield self.finding(
                ctx, node,
                f"{name} in the card's engine — replay tables are "
                f"float64 by contract; a float32 cast truncates "
                f"charge/time columns and breaks bit-parity")

    def visit_Call(self, ctx, node):
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr == "float" and not node.args:
            yield self.finding(
                ctx, node,
                ".float() casts to float32 in the card's engine — "
                "replay tables are float64 by contract")
        # dtype="float32" string form
        for kw in node.keywords:
            if kw.arg == "dtype" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value == "float32":
                yield self.finding(
                    ctx, node,
                    'dtype="float32" in the card\'s engine — replay '
                    'tables are float64 by contract')

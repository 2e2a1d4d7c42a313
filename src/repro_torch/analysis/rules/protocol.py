"""Ask/tell protocol conformance rules.

Port copy of ``src/repro/analysis/rules/protocol.py``, unchanged.

Since the PR-4 inversion, strategies are transition systems: the
``SearchDriver`` owns the evaluate loop (ask → ``runner.run_batch`` →
tell), budget handling, and RNG stepping order. A strategy that calls the
runner itself bypasses budget accounting, trace recording, and the fused
``drive_many`` path; a state that retains the space/runner across a
snapshot boundary either bloats the pickle with a live cache or breaks
resume outright.
"""
from __future__ import annotations

import ast

from ..core import ERROR, Rule, dotted
from .pickle_safety import _is_state_class, _self_assign_names

_RUN_METHODS = frozenset({"run", "run_batch", "run_fused",
                          "run_repeats_fused"})

# methods of a state where (re)binding space/runner is the documented
# lifecycle (driver.SearchState): construction, re-binding on resume,
# unpickling
_BIND_METHODS = frozenset({"__init__", "bind", "__setstate__"})


def _is_runner_receiver(recv: ast.AST) -> bool:
    name = dotted(recv)
    if name is None:
        return False
    last = name.rsplit(".", 1)[-1]
    return last in ("runner", "_runner", "inner_runner")


class DirectRunnerCall(Rule):
    name = "protocol-runner-call"
    severity = ERROR
    scope = ("core/strategies/",)
    invariant = ("strategies never call runner.run*() themselves — the "
                 "SearchDriver owns the evaluate loop, budget placement, "
                 "and trace order")
    oracle = ("fused==sequential and fixture/legacy parity "
              "(tests/test_protocol.py); ProtocolDeprecationWarning "
              "escalated to error in tier-1")

    def visit_Call(self, ctx, node):
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _RUN_METHODS \
                and _is_runner_receiver(node.func.value):
            yield self.finding(
                ctx, node,
                f"direct runner.{node.func.attr}() call inside a strategy "
                f"module — evaluation must flow through the SearchDriver "
                f"ask/tell loop (return configs from ask(), read results "
                f"in tell())")


class StateRetainsRuntime(Rule):
    name = "protocol-state-retention"
    severity = ERROR
    scope = ("core/",)
    invariant = ("SearchState subclasses only (re)bind space/runner in "
                 "__init__/bind/__setstate__; pickled attributes must "
                 "not smuggle live runtime across snapshot boundaries")
    oracle = ("pickle-resume for all 9 strategies + no-partial-tell "
              "(tests/test_protocol.py); __getstate__ drops the space")

    def visit_ClassDef(self, ctx, node):
        if not _is_state_class(node):
            return
        for attr, assign, method in _self_assign_names(node):
            if attr in ("space", "runner") and method not in _BIND_METHODS:
                yield self.finding(
                    ctx, assign,
                    f"self.{attr} assigned in {node.name}.{method}() — "
                    f"states re-attach runtime via bind()/attach_runner() "
                    f"with underscore (unpickled-away) attributes; a "
                    f"pickleable {attr!r} reference crosses the snapshot "
                    f"boundary")

"""Pickle-safety rules.

Process-pool campaigns ship scorers, caches, and mid-run ``SearchState``
snapshots through pickle (core/parallel.py, core/driver.py). Two classes
of objects must never reach the pickle stream:

  * memoized device/columnar mirrors (``CacheColumns._jax``,
    ``CompiledSpace._jax``, ``CacheFile._columns``, ``_space_rows``) —
    jax device arrays don't unpickle portably, and a worker must rebuild
    its mirrors against whatever backend it actually has;
  * device arrays inside ``SearchState`` subclasses — states snapshot
    mid-run into journals (``meta_hypertune``) and resume in arbitrary
    processes.

Port copy of ``src/repro/analysis/rules/pickle_safety.py``. Changed: the
mirror-cache attributes are the port's (``CacheColumns._device``,
``CompiledSpace._device``, ``SimulationRunner._torch_eng``,
``CacheFile._columns``, ``_space_rows``: ``_device*``, ``_torch*``), and
a state's device expressions are ``torch`` ones (a CUDA tensor pickles
bound to its card).
"""
from __future__ import annotations

import ast
import re

from ..core import ERROR, Rule, dotted

# attribute names that hold device/columnar mirror caches by convention
# (CacheColumns._device, CompiledSpace._device, SimulationRunner._torch_eng,
# CacheFile._columns, CacheColumns._space_rows)
_CACHE_ATTR = re.compile(r"^(_device\w*|_torch\w*|_columns|_space_rows)$")

_PICKLE_HOOKS = ("__getstate__", "__reduce__", "__reduce_ex__")


def _class_methods(cls: ast.ClassDef) -> list[ast.FunctionDef]:
    return [n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _self_assign_names(cls: ast.ClassDef):
    """Yield (attr-name, assignment-node, enclosing-method-name) for every
    ``self.X = ...`` in the class body."""
    for method in _class_methods(cls):
        for node in ast.walk(method):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                targets = [node.target]
            for t in targets:
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self":
                    yield t.attr, node, method.name


def _slots_names(cls: ast.ClassDef) -> list[str]:
    for node in cls.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__slots__" \
                        and isinstance(node.value,
                                       (ast.Tuple, ast.List, ast.Set)):
                    return [e.value for e in node.value.elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, str)]
    return []


def _is_state_class(cls: ast.ClassDef) -> bool:
    """Heuristic: any base whose (dotted-last) name contains 'State' —
    covers SearchState, _ReplayBridgeState, GeneratorBridgeState, ..."""
    for base in cls.bases:
        name = dotted(base)
        if name and "State" in name.rsplit(".", 1)[-1]:
            return True
    return False


class DeviceCacheNotDropped(Rule):
    name = "pickle-device-cache"
    severity = ERROR
    scope = ()
    invariant = ("classes holding device/columnar mirror caches "
                 "(_device*, _torch*, _columns, _space_rows) define "
                 "__getstate__/__reduce__ "
                 "to drop them before pickling")
    oracle = ("device-arrays-never-pickle tests (tests/test_parallel.py) "
              "and process-pool campaign determinism")

    def visit_ClassDef(self, ctx, node):
        cached = sorted(
            {attr for attr, _, _ in _self_assign_names(node)
             if _CACHE_ATTR.match(attr)}
            | {s for s in _slots_names(node) if _CACHE_ATTR.match(s)})
        if not cached:
            return
        methods = {m.name for m in _class_methods(node)}
        if not methods.intersection(_PICKLE_HOOKS):
            yield self.finding(
                ctx, node,
                f"class {node.name} holds mirror cache(s) "
                f"{', '.join(cached)} but defines no "
                f"__getstate__/__reduce__ to drop them — pickling would "
                f"ship device arrays to workers")


class StateDeviceAttr(Rule):
    name = "pickle-state-device-attr"
    severity = ERROR
    scope = ()
    invariant = ("SearchState subclasses never assign torch/device-tensor "
                 "attributes: states snapshot into journals and resume "
                 "in arbitrary processes")
    oracle = ("pickle-resume conformance for all strategies "
              "(tests/test_protocol.py) incl. cross-engine resume")

    _DEVICE_ROOTS = ("torch",)

    def _is_device_expr(self, expr: ast.AST) -> bool:
        for node in ast.walk(expr):
            name = None
            if isinstance(node, (ast.Attribute, ast.Name)):
                name = dotted(node)
            if name:
                root = name.split(".", 1)[0]
                if root in self._DEVICE_ROOTS or name.endswith(".cuda"):
                    return True
        return False

    def visit_ClassDef(self, ctx, node):
        if not _is_state_class(node):
            return
        for attr, assign, _method in _self_assign_names(node):
            if attr.startswith("_"):
                continue  # underscore attrs are dropped by __getstate__
            value = getattr(assign, "value", None)
            if value is not None and self._is_device_expr(value):
                yield self.finding(
                    ctx, assign,
                    f"state attribute self.{attr} is assigned a "
                    f"torch/device expression — SearchState pickles must "
                    f"stay host-only (convert with .cpu().numpy(), or use an "
                    f"underscore attribute rebuilt on bind())")

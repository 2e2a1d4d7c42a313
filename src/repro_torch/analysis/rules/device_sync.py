"""Device→host sync discipline for the card engine's hot loops.

The fused-campaign and free-running throughput hinges on one shape: a
handful of batched launches, then *one* bulk copy per output. An implicit
element-wise sync — ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``/
``float()``/``int()``/``np.asarray`` applied to a device tensor inside a
loop body — blocks on the card once per iteration and silently turns an
O(launches) campaign back into the O(evaluations) round-trip pattern the
fused executor and ``free_run`` exist to remove.

The rule is a conservative local dataflow with one structural judgment,
"convert where you dispatch": names assigned from ``torch.*`` calls, from
tensor ``.to(...)``/``.cuda()`` and from the port's kernel wrappers
(``budget_scan``, ``budget_scan_plain``, ``replay_many``) are device
values, and converting one inside a loop is an error **unless** the value
was produced inside the same innermost loop's per-iteration region — the
batched-output idiom (launch in the loop, one bulk conversion per output
right after it) stays clean, while per-element syncs of device values
produced outside the loop are flagged. A conversion's *result* is a host
value: ``spent = out[4].cpu().numpy()`` then ``float(spent[i])`` in a
loop syncs nothing. A device value the loop *carries* — assigned before
the loop and again inside it, as ``free_run``'s budget, ``seen`` and best
tensors — is the loop's device state, not a batched output: converting it
inside the loop is flagged even though the loop assigns it.

Port copy of ``src/repro/analysis/rules/device_sync.py``. Changed, for
the port's device and library: the scope is ``core/engine_torch/``;
device values come from ``torch.*``, ``.to``/``.cuda`` and the kernel
wrappers instead of ``jnp.*``/``jax.*`` and jitted callables; the
conversions are torch's (``.item()``, ``.tolist()``, ``.cpu()``,
``.numpy()``, ``float()``, ``int()``, ``bool()``, ``np.asarray``/
``np.array``); and a loop-carried device value is not blessed by being
reassigned in the loop (the reference blesses every name the loop
assigns, which would let a per-generation ``float(spent.max())`` in
``free_run`` pass).
"""
from __future__ import annotations

import ast

from ..core import ERROR, Rule, call_name

# conversion callables that force a device→host transfer per call
_CONVERT_CALLS = frozenset({
    "np.asarray", "numpy.asarray", "np.array", "numpy.array", "float",
    "int", "bool",
})
# conversion methods on tensor receivers
_CONVERT_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})

_DEVICE_ROOTS = ("torch",)
# tensor methods whose result is a device value
_DEVICE_METHODS = frozenset({"to", "cuda"})
# the port's kernel wrappers: their results are device tensors
_KERNEL_WRAPPERS = frozenset({"budget_scan", "budget_scan_plain",
                              "replay_many"})

_LOOPS = (ast.For, ast.While, ast.GeneratorExp, ast.ListComp,
          ast.SetComp, ast.DictComp)


def _is_device_call(node: ast.Call) -> bool:
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in _DEVICE_METHODS:
        return True
    name = call_name(node)
    if name is None:
        return False
    root = name.split(".", 1)[0]
    if root in _DEVICE_ROOTS:
        return True
    return name.rsplit(".", 1)[-1] in _KERNEL_WRAPPERS


def _is_conversion(node: ast.AST) -> bool:
    """Top-level host conversion: its result lives on the host."""
    if not isinstance(node, ast.Call):
        return False
    if call_name(node) in _CONVERT_CALLS:
        return True
    return (isinstance(node.func, ast.Attribute)
            and node.func.attr in _CONVERT_METHODS)


def _target_names(target: ast.AST):
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from _target_names(elt)


def _device_names_in(expr: ast.AST, device: set) -> set:
    return {n.id for n in ast.walk(expr)
            if isinstance(n, ast.Name) and n.id in device}


def _refs_device(expr: ast.AST, device: set) -> bool:
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and node.id in device:
            return True
        if isinstance(node, ast.Call) and _is_device_call(node):
            return True
    return False


def _walk_function(func: ast.AST):
    """Every node of ``func``'s own body, skipping nested function defs
    (they get their own visit)."""
    stack = list(ast.iter_child_nodes(func))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _device_assigns(node: ast.AST, device: set):
    """(targets-iterable, value) pairs for assignments whose value is a
    device expression (and not a top-level host conversion)."""
    if isinstance(node, ast.Assign):
        value, targets = node.value, node.targets
    elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
        value, targets = node.value, [node.target]
    else:
        return
    if value is None or _is_conversion(value) \
            or not _refs_device(value, device):
        return
    for t in targets:
        yield from _target_names(t)


def _collect_device_names(func: ast.AST) -> set:
    """Fixpoint over assignments/loop targets: names holding device
    values. Conversion results are host values and do not propagate."""
    device: set = set()
    for _ in range(3):
        before = len(device)
        for node in _walk_function(func):
            device.update(_device_assigns(node, device))
            if isinstance(node, ast.For) \
                    and _refs_device(node.iter, device):
                device.update(_target_names(node.target))
            elif isinstance(node, ast.comprehension) \
                    and _refs_device(node.iter, device):
                device.update(_target_names(node.target))
        if len(device) == before:
            break
    return device


def _carried_into(loop: ast.AST, func: ast.AST, device: set) -> set:
    """Device names assigned in ``func`` before ``loop`` starts: if the
    loop assigns them again, they are state the loop carries."""
    before: set = set()
    for node in _walk_function(func):
        if getattr(node, "lineno", loop.lineno) < loop.lineno:
            before.update(_device_assigns(node, device))
    return before


def _loop_region_defs(loop: ast.AST, device: set, func: ast.AST) -> set:
    """Device names produced inside ``loop``'s per-iteration region and
    not carried into it — converting these where they were dispatched is
    the blessed idiom."""
    defs: set = set()
    if isinstance(loop, (ast.For, ast.While)):
        region = list(loop.body) + list(loop.orelse)
        if isinstance(loop, ast.While):
            region.append(loop.test)
        for stmt in region:
            for node in ast.walk(stmt):
                defs.update(_device_assigns(node, device))
    # comprehensions assign nothing: defs stay empty, every outside
    # device name converted per-element is a violation
    return defs - _carried_into(loop, func, device)


class DeviceSyncInLoop(Rule):
    name = "device-sync-in-loop"
    severity = ERROR
    scope = ("core/engine_torch/",)
    invariant = ("engine_torch hot loops never convert device tensors "
                 "element-wise: .item()/.tolist()/.cpu()/.numpy()/"
                 "float()/int()/np.asarray on a device value inside a "
                 "loop body is an error unless the value was dispatched "
                 "in that same loop iteration")
    oracle = ("host synchronisations of a free_run call independent of "
              "its generations (chip_smoke.py phase 10 (h), "
              "torch.cuda.set_sync_debug_mode)")

    def _conversion_arg(self, node: ast.Call) -> "ast.AST | None":
        name = call_name(node)
        if name in _CONVERT_CALLS and node.args:
            return node.args[0]
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _CONVERT_METHODS and not node.args:
            return node.func.value
        return None

    def _innermost_loop(self, func, node, chain):
        """Nearest enclosing loop of ``node`` within ``func``; a ``for``'s
        iterable and a comprehension's first source evaluate once and do
        not count as being inside that loop."""
        child = node
        for anc in chain:
            if anc is func:
                return None
            if isinstance(anc, (ast.For,)) and child is not anc.iter \
                    and child is not anc.target:
                return anc
            if isinstance(anc, ast.While):
                return anc
            if isinstance(anc, (ast.GeneratorExp, ast.ListComp,
                                ast.SetComp, ast.DictComp)) \
                    and child is not anc.generators[0].iter:
                return anc
            child = anc
        return None

    def _visit_function(self, ctx, func):
        device = _collect_device_names(func)
        if not device:
            return
        # parent chains from the local walk (framework parents exist too,
        # but the local walk already excludes nested functions)
        parents: dict = {}
        for node in _walk_function(func):
            for child in ast.iter_child_nodes(node):
                parents[id(child)] = node
        region_defs: dict = {}
        for node in _walk_function(func):
            if not isinstance(node, ast.Call):
                continue
            arg = self._conversion_arg(node)
            if arg is None:
                continue
            names = _device_names_in(arg, device)
            if not names:
                continue
            chain = []
            cur = parents.get(id(node))
            while cur is not None:
                chain.append(cur)
                cur = parents.get(id(cur))
            chain.append(func)
            loop = self._innermost_loop(func, node, chain)
            if loop is None:
                continue
            if id(loop) not in region_defs:
                region_defs[id(loop)] = _loop_region_defs(loop, device,
                                                           func)
            escaped = names - region_defs[id(loop)]
            if not escaped:
                continue  # batched-output idiom: converted where dispatched
            yield self.finding(
                ctx, node,
                f"device→host sync in a loop body: converting "
                f"{', '.join(sorted(escaped))} (a device value produced "
                f"outside this loop) once per iteration — launch once "
                f"and convert the batched output outside the loop (see "
                f"strategies.free_run)")

    def visit_FunctionDef(self, ctx, node):
        yield from self._visit_function(ctx, node)

    def visit_AsyncFunctionDef(self, ctx, node):  # pragma: no cover
        yield from self._visit_function(ctx, node)

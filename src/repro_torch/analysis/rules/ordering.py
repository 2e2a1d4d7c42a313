"""Ordering-hazard rules.

Port copy of ``src/repro/analysis/rules/ordering.py``, unchanged.

Shard discovery, journal replay, and cache merging are deterministic only
because every enumeration the output depends on has a defined order
(core/record.py merges by explicit (worker, path) rank; the hub loads in
sorted-key order). ``os.listdir``/``glob`` return filesystem order —
which differs between machines and even between runs — and set iteration
follows per-process hash order. Both are fine *inside* a computation
whose result is order-insensitive, but the cheap, always-safe fix is to
sort at the producer, so that is what the rules demand.
"""
from __future__ import annotations

import ast

from ..core import (ERROR, WARNING, Rule, call_name, dotted, enclosing,
                    is_set_expr, parent, wrapped_in_sorted)

_FS_ENUMERATORS = frozenset({
    "os.listdir", "os.scandir", "glob.glob", "glob.iglob",
})
_PATH_METHODS = frozenset({"iterdir", "glob", "rglob"})

_ENV_MUTATORS = frozenset({
    "os.environ.setdefault", "os.environ.update", "os.environ.pop",
    "os.environ.clear", "os.environ.popitem", "os.putenv", "os.unsetenv",
})
_DEF_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef)


class UnsortedDirectoryIteration(Rule):
    name = "ordering-listdir"
    severity = ERROR
    scope = ()
    invariant = ("directory enumerations are sorted at the call site — "
                 "filesystem order differs across machines, so anything "
                 "derived from it (shard discovery, checkpoint GC, "
                 "journal replay) would too")
    oracle = ("merge idempotence / shard-order independence "
              "(tests/test_record.py) and resumable-campaign tests")

    def visit_Call(self, ctx, node):
        full = call_name(node)
        is_fs = full in _FS_ENUMERATORS
        if not is_fs and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _PATH_METHODS:
            is_fs = True
            full = f"<path>.{node.func.attr}"
        if is_fs and not wrapped_in_sorted(node):
            yield self.finding(
                ctx, node,
                f"{full}(...) without sorted() — filesystem enumeration "
                f"order is not deterministic; wrap the call in sorted()")


class SetOrderedIteration(Rule):
    name = "ordering-set-iteration"
    severity = WARNING
    scope = ("core/",)
    invariant = ("core/ never iterates a set directly — hash order leaks "
                 "into whatever the loop builds (journal lines, cache "
                 "records, reduction order)")
    oracle = ("bit-identical parallel campaigns across worker counts "
              "(tests/test_parallel.py)")

    def _flag(self, ctx, node):
        return self.finding(
            ctx, node,
            "iteration directly over a set — order follows per-process "
            "hash order; iterate sorted(...) (or keep a list/dict, which "
            "preserve insertion order)")

    def visit_For(self, ctx, node):
        if is_set_expr(node.iter) and not wrapped_in_sorted(node.iter):
            yield self._flag(ctx, node.iter)

    def visit_comprehension(self, ctx, node):
        if is_set_expr(node.iter) and not wrapped_in_sorted(node.iter):
            comp = parent(node)
            # building another set/frozenset from a set is order-free
            if isinstance(comp, (ast.SetComp,)):
                return
            yield self._flag(ctx, node.iter)


class ImportTimeEnvMutation(Rule):
    name = "ordering-import-env-mutation"
    severity = ERROR
    scope = ()
    invariant = ("importing a module never mutates the process environment "
                 "— an import-time os.environ write (e.g. XLA_FLAGS) "
                 "changes behavior for every importer depending on import "
                 "*order*, and jax locks some of it in at first backend "
                 "init; environment setup belongs behind main()/CLI entry")
    oracle = ("library importers see an unchanged environment "
              "(launch.dryrun is importable without forcing 512 devices)")

    def _module_level(self, node) -> bool:
        return enclosing(node, *_DEF_SCOPES) is None

    def visit_Assign(self, ctx, node):
        for tgt in node.targets:
            if (isinstance(tgt, ast.Subscript)
                    and dotted(tgt.value) == "os.environ"
                    and self._module_level(node)):
                yield self.finding(
                    ctx, node,
                    "os.environ[...] assigned at module import time — "
                    "move the mutation behind main()/the CLI entry point")
                return

    def visit_Call(self, ctx, node):
        full = call_name(node)
        if full in _ENV_MUTATORS and self._module_level(node):
            yield self.finding(
                ctx, node,
                f"{full}(...) at module import time mutates the process "
                f"environment — move it behind main()/the CLI entry point")

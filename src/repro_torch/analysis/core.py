"""The parity-lint framework: AST visitor core, rule protocol, driver.

Port copy of ``src/repro/analysis/core.py``. Changed: findings are keyed
relative to the ``repro_torch`` package (``module_path``), so scopes read
``core/``, ``core/engine_torch/``, ...

Every invariant this linter encodes is backed by a *runtime* oracle
somewhere in the tree (a trace fixture, a parity test, the bench score
checksum). The oracles catch a determinism hazard only when some fixture
happens to exercise it; the linter catches the hazard the moment it is
written. docs/static-analysis.md catalogues the rules; each ``Rule``
subclass carries its one-line ``invariant`` and a pointer to the
``oracle`` that backs it, so the catalogue can be generated from the
registry (``python -m repro_torch lint --list-rules``).

Mechanics:

  * ``Finding`` — one diagnostic: module-relative path, position, rule id,
    severity (``error``/``warning`` — both gate in CI; severity ranks the
    report), message.
  * ``Rule`` — a visitor: ``visit_<NodeType>`` methods receive every node
    of that type from a single shared walk; ``check_module`` runs once per
    file. ``scope`` restricts a rule to path prefixes relative to the
    ``repro_torch`` package (``core/``, ``core/engine_torch/``, ...).
  * ``lint_source``/``lint_paths`` — the driver: parse, walk once
    dispatching to all applicable rules, apply inline suppressions
    (``# parity-lint: disable=<rule>``), flag unused suppressions, then
    subtract the checked-in baseline (grandfathered findings).

The linter lints itself (``src/repro_torch/analysis`` is inside the default
target), so the framework obeys its own ordering rules — e.g. the file
walk below is sorted.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Iterable, Sequence

from .suppress import Suppressions

ERROR = "error"
WARNING = "warning"

# framework-owned rule ids (not in the rules/ registry)
SYNTAX_ERROR = "syntax-error"
UNUSED_SUPPRESSION = "unused-suppression"


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One diagnostic, ordered by position for deterministic reports."""

    path: str        # module-relative posix path, e.g. "core/record.py"
    line: int
    col: int         # 1-based
    rule: str
    severity: str
    message: str

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.severity}: "
                f"{self.message} [{self.rule}]")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class FileContext:
    """One parsed file: source lines plus an AST with parent links."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source)
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                child._pl_parent = parent  # type: ignore[attr-defined]

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""


# ------------------------------------------------------------- AST helpers
def parent(node: ast.AST) -> ast.AST | None:
    return getattr(node, "_pl_parent", None)


def dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> str | None:
    return dotted(node.func)


def enclosing(node: ast.AST, *types) -> ast.AST | None:
    n = parent(node)
    while n is not None:
        if isinstance(n, types):
            return n
        n = parent(n)
    return None


def wrapped_in_sorted(node: ast.AST) -> bool:
    """True when ``node`` is the direct argument of ``sorted(...)``."""
    p = parent(node)
    return (isinstance(p, ast.Call) and isinstance(p.func, ast.Name)
            and p.func.id == "sorted" and bool(p.args)
            and p.args[0] is node)


def is_set_expr(node: ast.AST) -> bool:
    """A set literal, comprehension, or ``set(...)``/``frozenset(...)``."""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in ("set", "frozenset"))


# ------------------------------------------------------------------- rules
class Rule:
    """Base rule. Subclasses define ``visit_<NodeType>`` methods (called
    from the shared walk with ``(ctx, node)``) and/or ``check_module``;
    both return an iterable of ``Finding``."""

    name: str = ""
    severity: str = ERROR
    scope: tuple[str, ...] = ()     # () = every linted file
    invariant: str = ""             # the contract this rule encodes
    oracle: str = ""                # the runtime check that backs it

    def applies_to(self, path: str) -> bool:
        return not self.scope or any(path.startswith(s) for s in self.scope)

    def finding(self, ctx: FileContext, node: ast.AST, message: str,
                severity: str | None = None) -> Finding:
        return Finding(ctx.path, getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0) + 1, self.name,
                       severity or self.severity, message)

    def check_module(self, ctx: FileContext) -> Iterable[Finding]:
        return ()

    def describe(self) -> dict:
        return {"rule": self.name, "severity": self.severity,
                "scope": list(self.scope) or ["**"],
                "invariant": self.invariant, "oracle": self.oracle}


def _handlers(rules: Sequence[Rule]) -> dict:
    by_type: dict[str, list] = {}
    for rule in rules:
        for attr in dir(rule):
            if attr.startswith("visit_") and hasattr(ast, attr[6:]):
                by_type.setdefault(attr[6:], []).append(getattr(rule, attr))
    return by_type


def lint_source(source: str, path: str,
                rules: Sequence[Rule]) -> list[Finding]:
    """Lint one file's source: parse, dispatch, suppress. Returns findings
    *before* baseline subtraction (the driver owns the baseline)."""
    sup = Suppressions(source)
    try:
        ctx = FileContext(path, source)
    except SyntaxError as exc:
        return [Finding(path, exc.lineno or 1, exc.offset or 1,
                        SYNTAX_ERROR, ERROR,
                        f"file does not parse: {exc.msg}")]
    applicable = [r for r in rules if r.applies_to(path)]
    handlers = _handlers(applicable)
    findings: list[Finding] = []
    for node in ast.walk(ctx.tree):
        for handler in handlers.get(type(node).__name__, ()):
            findings.extend(handler(ctx, node))
    for rule in applicable:
        findings.extend(rule.check_module(ctx))
    kept = [f for f in findings if not sup.suppresses(f.line, f.rule)]
    # an unused disable is itself a finding: it claims an exemption the
    # code no longer needs, and stale exemptions hide future regressions.
    # Deliberately not suppressible — delete the comment instead.
    kept.extend(
        Finding(path, line, 1, UNUSED_SUPPRESSION, WARNING,
                f"suppression 'parity-lint: disable={rule}' matched no "
                f"finding on this line")
        for line, rule in sup.unused())
    return sorted(kept)


# ------------------------------------------------------------------ driver
def module_path(file_path: str, root: str) -> str:
    """Path key for findings/baselines: relative to the ``repro_torch`` package
    when the file lives under one (stable across checkouts), else relative
    to the linted root (fixture trees in tests)."""
    posix = os.path.abspath(file_path).replace(os.sep, "/")
    marker = "/repro_torch/"
    i = posix.rfind(marker)
    if i != -1:
        return posix[i + len(marker):]
    rel = os.path.relpath(file_path, root if os.path.isdir(root)
                          else os.path.dirname(root) or ".")
    return rel.replace(os.sep, "/")


def iter_python_files(root: str) -> Iterable[str]:
    if os.path.isfile(root):
        yield root
        return
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()            # deterministic walk (our own medicine)
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in sorted(filenames):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


@dataclasses.dataclass
class LintResult:
    """Outcome of one lint run. ``findings`` is what gates (suppressions
    applied, baseline subtracted); ``baselined`` are the grandfathered
    matches; ``stale_baseline`` are baseline entries that no longer match
    anything (safe to delete from the baseline file)."""

    findings: list[Finding]
    baselined: list[Finding]
    stale_baseline: list[dict]
    n_files: int

    @property
    def ok(self) -> bool:
        return not self.findings

    def count(self, severity: str) -> int:
        return sum(1 for f in self.findings if f.severity == severity)


def lint_paths(paths: Sequence[str], baseline=None,
               rules: Sequence[Rule] | None = None) -> LintResult:
    """Lint every ``.py`` file under ``paths``. ``baseline`` is a
    ``baseline.Baseline``, a path to one, or None."""
    from . import default_rules
    from .baseline import Baseline
    if rules is None:
        rules = default_rules()
    if isinstance(baseline, str):
        baseline = Baseline.load(baseline)
    for p in paths:
        if not os.path.exists(p):
            raise ValueError(f"no such path: {p}")
    raw: list[Finding] = []
    texts: dict[str, list[str]] = {}
    n_files = 0
    for root in paths:
        for file_path in iter_python_files(root):
            n_files += 1
            with open(file_path, "r", encoding="utf-8") as f:
                source = f.read()
            mod = module_path(file_path, root)
            texts[mod] = source.splitlines()
            raw.extend(lint_source(source, mod, rules))

    def line_text(f: Finding) -> str:
        lines = texts.get(f.path, [])
        return lines[f.line - 1] if 1 <= f.line <= len(lines) else ""

    findings, grandfathered = [], []
    for f in sorted(raw):
        if baseline is not None and baseline.match(f, line_text(f)):
            grandfathered.append(f)
        else:
            findings.append(f)
    stale = baseline.stale() if baseline is not None else []
    return LintResult(findings, grandfathered, stale, n_files)


def run_source(source: str, path: str = "module.py",
               rules: Sequence[Rule] | None = None) -> list[Finding]:
    """Lint a source snippet under a pseudo module-relative ``path`` (which
    selects the scoped rules, e.g. ``core/x.py``) — the fixture entry point
    used throughout tests/test_analysis.py."""
    from . import default_rules
    return lint_source(source, path,
                       default_rules() if rules is None else rules)

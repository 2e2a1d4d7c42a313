"""Lint report rendering: human text and machine-readable JSON.

Port copy of ``src/repro/analysis/report.py``, unchanged.

The JSON form (``python -m repro_torch lint --format json``, and the CI
artifact via ``--report``) is versioned and self-describing: it embeds
the rule catalogue (invariant + runtime oracle per rule) alongside the
findings, so a report is interpretable without the source checkout.
"""
from __future__ import annotations

from .core import ERROR, WARNING, LintResult, Rule

REPORT_FORMAT = "parity-lint-report"
REPORT_VERSION = 1


def to_json(result: LintResult, rules=()) -> dict:
    return {
        "format": REPORT_FORMAT,
        "version": REPORT_VERSION,
        "ok": result.ok,
        "n_files": result.n_files,
        "n_errors": result.count(ERROR),
        "n_warnings": result.count(WARNING),
        "findings": [f.to_json() for f in result.findings],
        "baselined": [f.to_json() for f in result.baselined],
        "stale_baseline": list(result.stale_baseline),
        "rules": [r.describe() for r in rules],
    }


def to_text(result: LintResult) -> str:
    lines = [f.format() for f in result.findings]
    summary = (f"parity-lint: {result.count(ERROR)} error(s), "
               f"{result.count(WARNING)} warning(s) in "
               f"{result.n_files} file(s)")
    if result.baselined:
        summary += f"; {len(result.baselined)} baselined"
    if result.stale_baseline:
        lines.append(f"note: {len(result.stale_baseline)} stale baseline "
                     f"entr{'y' if len(result.stale_baseline) == 1 else 'ies'}"
                     f" no longer match anything — prune the baseline:")
        for e in result.stale_baseline:
            lines.append(f"  {e['path']}: [{e['rule']}] {e['context']}")
    lines.append(summary + (" — clean" if result.ok else ""))
    return "\n".join(lines)


def rule_catalogue(rules) -> str:
    """``--list-rules``: one block per rule, generated from the registry
    (the same data docs/static-analysis.md catalogues)."""
    blocks = []
    for r in sorted(rules, key=lambda r: r.name):
        scope = ", ".join(r.scope) if r.scope else "all linted files"
        blocks.append(f"{r.name} ({r.severity}; scope: {scope})\n"
                      f"  invariant: {r.invariant}\n"
                      f"  oracle:    {r.oracle}")
    return "\n".join(blocks)

"""Inline suppressions: ``# parity-lint: disable=<rule>[,<rule>...]``.

Port copy of ``src/repro/analysis/suppress.py``, unchanged.

A directive on a physical line exempts that line from the named rules
(``disable=all`` exempts it from every rule). The directive must sit on
the line the finding is reported at — for multi-line statements that is
the line of the offending expression, which the finding's position names
exactly.

Suppressions are tracked: a directive that never matches a finding is
reported by the framework-owned ``unused-suppression`` rule (see
``core.lint_source``), so exemptions cannot silently outlive the hazard
they were written for.
"""
from __future__ import annotations

import re

DIRECTIVE = re.compile(r"#\s*parity-lint:\s*disable=([A-Za-z0-9_,\- ]+)")


class Suppressions:
    """Per-file directive table with usage tracking."""

    def __init__(self, source: str):
        self.by_line: dict[int, tuple[str, ...]] = {}
        self._used: dict[tuple[int, str], bool] = {}
        for lineno, line in enumerate(source.splitlines(), 1):
            m = DIRECTIVE.search(line)
            if not m:
                continue
            rules = tuple(sorted({r.strip() for r in m.group(1).split(",")
                                  if r.strip()}))
            if rules:
                self.by_line[lineno] = rules
                for rule in rules:
                    self._used[(lineno, rule)] = False

    def suppresses(self, line: int, rule: str) -> bool:
        rules = self.by_line.get(line)
        if not rules:
            return False
        for candidate in (rule, "all"):
            if candidate in rules:
                self._used[(line, candidate)] = True
                return True
        return False

    def unused(self) -> list[tuple[int, str]]:
        return sorted(key for key, used in self._used.items() if not used)

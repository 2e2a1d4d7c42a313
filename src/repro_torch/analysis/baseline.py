"""Checked-in baseline of grandfathered findings.

Port copy of ``src/repro/analysis/baseline.py``, unchanged; the port's
baseline is ``src/repro_torch/analysis/parity-lint-baseline.json``.

The baseline exists for findings that are *deliberate* — code documented
to live outside the contract a rule encodes. Everything else gets fixed,
not baselined.

Entries are keyed by ``(rule, path, context)`` where ``context`` is the
stripped source line of the finding — stable under unrelated edits that
shift line numbers, invalidated the moment the offending line itself
changes (which is when a human should re-decide). Matching is
multiset-style: an entry absorbs at most ``count`` findings, so new
duplicates of a grandfathered pattern still gate. Entries that match
nothing are reported as *stale* so the baseline only ever shrinks.
"""
from __future__ import annotations

import json
from collections import Counter

BASELINE_FORMAT = "parity-lint-baseline"
BASELINE_VERSION = 1


def _key(rule: str, path: str, context: str) -> tuple:
    return (rule, path, " ".join(context.split()))


class Baseline:
    def __init__(self, entries=()):
        self._avail: Counter = Counter()
        for e in entries:
            self._avail[_key(e["rule"], e["path"], e.get("context", ""))] \
                += int(e.get("count", 1))

    @staticmethod
    def load(path: str) -> "Baseline":
        with open(path, "r", encoding="utf-8") as f:
            try:
                data = json.load(f)
            except json.JSONDecodeError as exc:
                raise ValueError(f"{path} is not a baseline file: {exc}")
        if not isinstance(data, dict) \
                or data.get("format") != BASELINE_FORMAT:
            raise ValueError(f"{path} is not a {BASELINE_FORMAT} file")
        return Baseline(data.get("entries", ()))

    def match(self, finding, line_text: str) -> bool:
        """Consume one baseline slot for this finding if available."""
        key = _key(finding.rule, finding.path, line_text)
        if self._avail.get(key, 0) > 0:
            self._avail[key] -= 1
            return True
        return False

    def stale(self) -> list[dict]:
        """Entries (or counts) that matched no current finding."""
        return [{"rule": r, "path": p, "context": c, "count": n}
                for (r, p, c), n in sorted(self._avail.items()) if n > 0]


def baseline_dict(findings, line_text_of) -> dict:
    """Serializable baseline covering ``findings`` (``--write-baseline``).
    Identical (rule, path, context) triples fold into one counted entry;
    output order is sorted, so the file is deterministic."""
    counts: Counter = Counter()
    for f in findings:
        counts[_key(f.rule, f.path, line_text_of(f))] += 1
    entries = [{"rule": r, "path": p, "context": c,
                **({"count": n} if n > 1 else {})}
               for (r, p, c), n in sorted(counts.items())]
    return {"format": BASELINE_FORMAT, "version": BASELINE_VERSION,
            "entries": entries}


def write(path: str, findings, line_text_of) -> int:
    data = baseline_dict(findings, line_text_of)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")
    return len(data["entries"])

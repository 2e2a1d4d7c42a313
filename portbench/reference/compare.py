"""How a campaign's outputs are judged against the reference's.

The reference follows a sample of a call's runs (their indices under
``runs``); each is compared with the program's run of that index. Three
numbers:

  * ``runs_off``: runs whose trajectory differs anywhere: the best value
    and row, the fresh and committed counts, whether the run stopped,
    and the best-so-far after every generation; exact, limit 0;
  * ``spend_gap_s``: the widest gap, in simulated seconds, between the
    two sides' float64 spend, after every generation and at the end;
    exact, limit 0;
  * ``runs_compared``: how many runs were compared; at least 1, so that
    a check that compared nothing is never correct.

A faithful program draws the same numbers from the same generator and
adds the same charges in the same order, so the first two read 0.
"""
from __future__ import annotations

import numpy as np

TRAJECTORY = ("best_value", "best_row", "fresh_evals", "spent_evals",
              "exhausted", "curve_best")
SPEND = ("spent_seconds", "curve_spent")
LIMITS = {"runs_off": {"at_most": 0}, "spend_gap_s": {"at_most": 0.0},
          "runs_compared": {"at_least": 1}}


def compare(got: dict, want: dict) -> dict:
    """``want``: the reference's outputs over the runs ``want["runs"]``;
    ``got``: the program's over all its runs, or, where it has ``runs``
    too (the control), over the same runs."""
    idx = np.asarray(want["runs"])
    runs = len(idx)
    off = np.zeros(runs, dtype=bool)
    gap = 0.0
    broken = {"runs_off": runs, "spend_gap_s": float("inf"),
              "runs_compared": runs}
    if "runs" in got and not np.array_equal(got["runs"], idx):
        return broken
    for key in TRAJECTORY + SPEND:
        a, b = np.asarray(got.get(key)), np.asarray(want[key])
        if "runs" not in got:
            if a.ndim == 0 or len(a) <= idx.max(initial=-1):
                return broken
            a = a[idx]
        if a.shape != b.shape:
            return broken
        same = a == b
        if a.dtype.kind == "f":
            same |= np.isnan(a) & np.isnan(b)
        off |= (~same).reshape(runs, -1).any(axis=1)
        if key in SPEND:
            d = np.abs(a.astype(np.float64) - b.astype(np.float64))
            d = np.where(np.isnan(d), np.inf, d)
            gap = max(gap, float(d.max(initial=0.0)))
    return {"runs_off": int(off.sum()), "spend_gap_s": gap,
            "runs_compared": runs}


def merge(readings: list) -> dict:
    """Several calls' readings as one: runs summed, the widest gap."""
    return {"runs_off": sum(r["runs_off"] for r in readings),
            "spend_gap_s": max((r["spend_gap_s"] for r in readings),
                               default=0.0),
            "runs_compared": sum(r["runs_compared"] for r in readings)}


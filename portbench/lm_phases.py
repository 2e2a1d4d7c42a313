"""A served model's own spans and counters in a ``--trace 1`` run, read
from what ``trace.Summary`` keeps: ``phases.py``'s reading, for the spans
of the port's ``hybrid_moe`` family.

While a profiler records, ``repro_torch.models.hybrid_moe`` opens host
spans on the profiler's clock: ``lm.prefill`` around a prefill, one
``lm.decode`` a decode step, and inside them ``lm.mamba`` or ``lm.attn``
around each layer's mixer and ``lm.moe`` around its experts; and it
counts, read by its ``counters()`` after the run, the traced prefills
(``calls``), the decode steps, the tokens through a MoE layer (a layer
each), the held experts' rows and the SSD scans' shapes. A program
without them gives no spans and no counters, and the readers of them
read nothing.

A kernel is put down to the innermost program span running when the
host launched it, by launch order, as in ``phases.py``. A CUDA graph's
replay (``cudaGraphLaunch``) launches the graph's kernels at once: where
the trace holds replays of one graph, each stands for an equal share of
the kernels the single launches leave over, all put down to the span
that ran the replay (``lm.decode`` for the family's decode steps). Where
the whole window's kernels and launches do not pair up (the profiler
lost a record), each traced call is paired on its own, and the calls
that pair up stand for all in the per-call readings.
"""
from __future__ import annotations

import functools
import sys

from portbench import phases

PROGRAM = "repro_torch.models.hybrid_moe"
SPANS = ("lm.prefill", "lm.decode", "lm.mamba", "lm.attn", "lm.moe")
# the kernels of one ssd_scan call, one launch each
SSD_KERNELS = ("ssd_chunk_states", "ssd_state_pass", "ssd_chunk_outputs")
# the CUDA runtime's and driver's replay of a captured graph
GRAPH_LAUNCH = ("cudaGraphLaunch", "cuGraphLaunch")


class LMPhases(phases.Phases):
    """``phases.Phases`` over the ``lm.*`` spans."""

    def __init__(self, summary):
        t = summary
        lo = min(s for s, _ in t._spans)
        hi = max(e for _, e in t._spans)
        self.spans = sorted(((s, e, n) for s, e, n in t._host
                             if n in SPANS), key=lambda x: (x[0], -x[1]))
        self._starts = [s for s, _, _ in self.spans]
        self._parent, stack = [], []
        for i, (s, _, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] <= s:
                stack.pop()
            self._parent.append(stack[-1] if stack else -1)
            stack.append(i)
        launches = sorted(s for s, _, n in t._host
                          if n.startswith(phases.LAUNCHES) and lo <= s <= hi)
        kernels = sorted(t.kernels(), key=lambda k: k.start_us)
        replays = sorted(s for s, _, n in t._host
                         if n.startswith(GRAPH_LAUNCH) and lo <= s <= hi)

        def paired(a, b) -> "list | None":
            """The kernels started from ``a`` to ``b`` with their launch
            times; None where the two do not pair up."""
            ks = [k for k in kernels if a <= k.start_us <= b]
            ls = with_replays([s for s in launches if a <= s <= b], len(ks),
                              [s for s in replays if a <= s <= b])
            return list(zip(ks, ls)) if ks and len(ls) == len(ks) else None

        pairs = paired(lo, hi)
        self.calls_paired = len(t._spans) if pairs else 0
        if pairs is None:
            calls = [c for c in (paired(a, b) for a, b in sorted(t._spans))
                     if c is not None]
            pairs = [x for c in calls for x in c] or None
            self.calls_paired = len(calls)
        self.by_kernel = (None if pairs is None
                          else [(k, self.at(s)) for k, s in pairs])
        self._gaps = t._gaps


def with_replays(launches: list, n_kernels: int, replays: list) -> list:
    """The host times of the kernels' launches, each graph replay's time
    standing for its share of the kernels that ``launches`` leave over
    (unchanged where there are no replays or the share is no whole
    number)."""
    extra = n_kernels - len(launches)
    if not replays or extra <= 0 or extra % len(replays):
        return launches
    each = extra // len(replays)
    return sorted(launches + [s for s in replays for _ in range(each)])


@functools.lru_cache(maxsize=1)
def of(summary) -> "LMPhases | None":
    """The served spans of a traced run; None without a trace or such
    spans."""
    if summary is None or not any(n in SPANS for _, _, n in summary._host):
        return None
    return LMPhases(summary)


def counters(run) -> "dict | None":
    """The program's counters over the traced calls; None where the
    program has none, or where they cover other calls than the
    trace's."""
    read = getattr(sys.modules.get(PROGRAM), "counters", None)
    if run.trace is None or not callable(read):
        return None
    values = read()
    if values.get("calls") != run.trace.calls:
        return None
    return values


def dev_ms_per_call(run, span: str) -> "float | None":
    """Device time of the kernels launched inside the spans ``span``, in
    ms a traced call."""
    p = of(run.trace)
    s = p.kernel_seconds(span) if p else None
    if s is None:
        return None
    return s * 1e3 / p.calls_paired

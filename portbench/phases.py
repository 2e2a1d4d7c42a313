"""The program's own spans and counters in a ``--trace 1`` run, read from
what ``trace.Summary`` keeps.

While a profiler records, the port's ``free_run`` marks its phases with
host spans on the profiler's clock: ``free_run`` around the call,
``free_run.init``, one ``free_run.gen`` a generation around
``free_run.ask``, ``.dedup``, ``.scan``, ``.tell`` and ``.commit``, and
``free_run.to_host``. It also counts, in module-level ints of
``repro_torch.core.engine_torch.strategies``, the traced calls, R x the
generations stepped, the run-generations whose run had not stopped at
the generation's start, and the generations whose start found every run
stopped. A program without them gives no spans and no counters, and the
readers of them read nothing.

A kernel is put down to the innermost program span running when the
host launched it. One stream runs kernels in launch order, so the traced
window's i-th kernel launch on the host is its i-th kernel on the
device; where the two counts differ, no kernel is put down.
"""
from __future__ import annotations

import bisect
import functools
import sys

PROGRAM = "repro_torch.core.engine_torch.strategies"
COUNTERS = ("calls", "run_gens", "live_run_gens", "dead_gens")
CALL = "free_run"          # the program span around a whole call
# the CUDA runtime and driver calls that launch one kernel each
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel",
            "cudaLaunchCooperativeKernel")


def is_span(name: str) -> bool:
    return name == CALL or name.startswith(CALL + ".")


class Phases:
    """The program spans of a traced window and its kernels by span."""

    def __init__(self, summary):
        t = summary
        lo = min(s for s, _ in t._spans)
        hi = max(e for _, e in t._spans)
        # outer spans first where two start together
        self.spans = sorted(((s, e, n) for s, e, n in t._host if is_span(n)),
                            key=lambda x: (x[0], -x[1]))
        self._starts = [s for s, _, _ in self.spans]
        self._parent, stack = [], []
        for i, (s, _, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] <= s:
                stack.pop()
            self._parent.append(stack[-1] if stack else -1)
            stack.append(i)
        launches = sorted(s for s, _, n in t._host
                          if n.startswith(LAUNCHES) and lo <= s <= hi)
        kernels = sorted(t.kernels(), key=lambda k: k.start_us)
        self.by_kernel = None     # [(kernel, its span's name or None)]
        if kernels and len(launches) == len(kernels):
            self.by_kernel = [(k, self.at(s))
                              for k, s in zip(kernels, launches)]
        self._gaps = t._gaps

    def at(self, t: float) -> "str | None":
        """The innermost program span running at host time ``t``."""
        i = bisect.bisect_right(self._starts, t) - 1
        while i >= 0 and self.spans[i][1] < t:
            i = self._parent[i]
        return self.spans[i][2] if i >= 0 else None

    def kernel_seconds(self, name: str) -> "float | None":
        """Device time of the kernels launched inside ``name`` and in no
        span inside it; None where none was."""
        if self.by_kernel is None:
            return None
        us = [k.end_us - k.start_us for k, n in self.by_kernel if n == name]
        return sum(us) / 1e6 if us else None

    def host_seconds(self, name: str) -> "float | None":
        """Host time of the spans ``name``; None where there is none."""
        us = [e - s for s, e, n in self.spans if n == name]
        return sum(us) / 1e6 if us else None

    def idle_seconds(self, name: str) -> "float | None":
        """Device idle time inside the host ranges of the spans ``name``
        (which do not overlap each other); None where there is none."""
        ranges = [(s, e) for s, e, n in self.spans if n == name]
        if not ranges:
            return None
        gaps = self._gaps
        ends = [b for _, b in gaps]
        us = 0.0
        for s, e in ranges:
            i = bisect.bisect_right(ends, s)    # the first gap ending after s
            while i < len(gaps) and gaps[i][0] < e:
                us += min(gaps[i][1], e) - max(gaps[i][0], s)
                i += 1
        return us / 1e6


@functools.lru_cache(maxsize=1)
def of(summary) -> "Phases | None":
    """The phases of a traced run; None without a trace or program
    spans."""
    if summary is None or not any(is_span(n) for _, _, n in summary._host):
        return None
    return Phases(summary)


def counters(run) -> "dict | None":
    """The program's counters over the traced calls: they count only
    while a profiler records, so at the end of a run they hold the traced
    calls alone. None where the program has none, or where they cover
    other calls than the trace's."""
    mod = sys.modules.get(PROGRAM)
    values = {n: getattr(mod, n, None) for n in COUNTERS}
    if not all(isinstance(v, int) for v in values.values()):
        return None
    if run.trace is None or values["calls"] != run.trace.calls:
        return None
    return values

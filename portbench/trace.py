"""The traced part of a ``--trace 1`` run, read from ``torch.profiler``.

``Tracer.around()`` wraps a call of the window in a span
(``portbench.call``); the profiler runs over the first ``calls`` calls.
``Summary`` reduces the trace to what the per-layer readers take:

  * every device operation (kernels, copies, fills) with its device time;
  * ``window_s``: from the first traced call's start to the last one's
    end, on the profiler's clock;
  * ``busy_s``: the time in that window in which some operation ran on the
    device (overlaps counted once);
  * the idle gaps between device operations, each named by the innermost
    host span or operation running at its midpoint.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses

SPAN = "portbench.call"
TOP = 10


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_us: float
    end_us: float

    @property
    def is_kernel(self) -> bool:
        return not self.name.startswith(("Memcpy", "Memset"))

    @property
    def is_to_host(self) -> bool:
        """A copy from the device to the host's memory."""
        return self.name.startswith("Memcpy DtoH")


class Summary:
    def __init__(self, ops: list, host: list, spans: list, calls: int):
        self.calls = calls
        lo = min(s for s, _ in spans)
        hi = max(e for _, e in spans)
        self.window_s = (hi - lo) / 1e6
        self.ops = [o for o in ops if o.end_us > lo and o.start_us < hi]
        busy, gaps = 0.0, []
        cur_s, cur_e = lo, lo       # an empty busy interval at the start
        for o in sorted(self.ops, key=lambda o: o.start_us):
            s, e = max(o.start_us, lo), min(o.end_us, hi)
            if s > cur_e:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        if hi > cur_e:
            gaps.append((cur_e, hi))
        self.busy_s = busy / 1e6
        self._host = sorted(host)
        self._spans = spans
        self._gaps = gaps

    def kernels(self) -> list:
        return [o for o in self.ops if o.is_kernel]

    def device_seconds(self) -> dict:
        out: dict = {}
        for o in self.ops:
            out[o.name] = out.get(o.name, 0.0) + (o.end_us - o.start_us) / 1e6
        return out

    def _host_at(self, t: float) -> str:
        """The innermost host event running at time ``t`` (the latest
        started among those that cover it); the call's span where no
        operation does (the host runs Python between operations)."""
        i = bisect.bisect_right(self._host, (t, float("inf"), "")) - 1
        for s, e, name in reversed(self._host[max(0, i - 256):i + 1]):
            if s <= t <= e:
                return name
        if any(s <= t <= e for s, e in self._spans):
            return SPAN
        return "no host event"

    def idle_by_host(self) -> dict:
        out: dict = {}
        for a, b in self._gaps:
            name = self._host_at(0.5 * (a + b))
            out[name] = out.get(name, 0.0) + (b - a) / 1e6
        return out

    def breakdown(self) -> dict:
        def top(d):
            rows = sorted(d.items(), key=lambda kv: -kv[1])[:TOP]
            return [[name[:160], sec] for name, sec in rows]
        return {"device_ops": top(self.device_seconds()),
                "idle_gaps": top(self.idle_by_host())}


class Tracer:
    """Profiles the first ``calls`` calls of a window (fewer where the
    window ends first: ``stop`` closes the trace after the window).
    ``start`` runs before the window, so the profiler's own start-up
    falls outside it."""

    def __init__(self, calls: int):
        self.calls = calls
        self.traced = 0
        self.prof = None
        self.active = False

    def start(self) -> None:
        """Start the profiler, before the window opens."""
        from torch.profiler import ProfilerActivity, profile
        _sync()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.active = True

    @contextlib.contextmanager
    def around(self):
        from torch.profiler import record_function
        if not self.active:
            yield
            return
        with record_function(SPAN):
            yield
        self.traced += 1
        if self.traced >= self.calls:
            self.stop()

    def stop(self) -> None:
        if self.active:
            _sync()
            self.prof.__exit__(None, None, None)
            self.active = False

    def summary(self) -> "Summary | None":
        self.stop()
        if self.prof is None or not self.traced:
            return None
        from torch.autograd import DeviceType
        ops, host, spans = [], [], []
        for e in self.prof.events():
            s, t = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                if e.name != SPAN:  # the span's own device-side range
                    ops.append(DeviceOp(e.name, s, t))
            elif e.name == SPAN:
                spans.append((s, t))
            else:
                host.append((s, t, e.name))
        if not spans:
            return None
        return Summary(ops, host, spans, self.traced)


def _sync() -> None:
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()

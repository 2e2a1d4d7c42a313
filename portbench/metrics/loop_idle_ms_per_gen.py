"""Device idle time inside the host ranges of the ``free_run.gen`` spans
(the profiler's clock is shared), in ms a generation of the traced
calls: the device waiting on the host's loop; nothing where the trace
holds no such span."""
from portbench import phases


def read(run):
    p = phases.of(run.trace)
    s = p.idle_seconds("free_run.gen") if p else None
    if s is None:
        return None
    return s * 1e3 / (run.trace.calls * run.facts["generations"])

"""Device time of the kernels launched in ``free_run.dedup`` (the
first-occurrence compare and the ``seen`` gather), in ms a generation of
the traced calls; nothing where the trace holds no such kernel."""
from portbench import phases


def read(run):
    p = phases.of(run.trace)
    s = p.kernel_seconds("free_run.dedup") if p else None
    if s is None:
        return None
    return s * 1e3 / (run.trace.calls * run.facts["generations"])

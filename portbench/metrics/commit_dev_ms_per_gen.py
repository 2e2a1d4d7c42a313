"""Device time of the kernels launched in ``free_run.commit`` (the ``seen``
scatter, the fresh counts, the best-so-far, the freeze of stopped runs'
state, ``stopped`` and the curve writes), in ms a generation of the
traced calls; nothing where the trace holds no such kernel."""
from portbench import phases


def read(run):
    p = phases.of(run.trace)
    s = p.kernel_seconds("free_run.commit") if p else None
    if s is None:
        return None
    return s * 1e3 / (run.trace.calls * run.facts["generations"])

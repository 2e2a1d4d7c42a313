"""Device time of the kernels launched in ``free_run.init`` (the tables,
the generator, the strategy's ``init``, the state tensors), in ms a
traced call; nothing where the trace holds no such kernel."""
from portbench import phases


def read(run):
    p = phases.of(run.trace)
    s = p.kernel_seconds("free_run.init") if p else None
    if s is None:
        return None
    return s * 1e3 / run.trace.calls

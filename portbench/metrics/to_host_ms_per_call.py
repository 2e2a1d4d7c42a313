"""Host time of the ``free_run.to_host`` span, in ms a traced call: the
outputs' copies to the host as the caller waits for them
(``d2h_ms_per_call`` is their device time alone); nothing where the
trace holds no such span."""
from portbench import phases


def read(run):
    p = phases.of(run.trace)
    s = p.host_seconds("free_run.to_host") if p else None
    if s is None:
        return None
    return s * 1e3 / run.trace.calls

"""The share of the served model's ``lm.decode`` spans in which the
device is idle, in %: device idle inside the spans' host ranges over
their host length, decode's pace set by the host; nothing where the
trace holds no such span."""
from portbench import lm_phases


def read(run):
    p = lm_phases.of(run.trace)
    if p is None:
        return None
    host = p.host_seconds("lm.decode")
    if not host:
        return None
    return 100.0 * p.idle_seconds("lm.decode") / host

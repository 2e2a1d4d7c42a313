"""Kernel launches a generation in the traced calls: the profiler's
kernels (copies and fills left out) over calls x generations."""


def read(run):
    t = run.trace
    if t is None or not t.kernels():
        return None
    return len(t.kernels()) / (t.calls * run.facts["generations"])

"""Device time of every kernel but the budget scan, in ms a generation
of the traced calls: the strategies' ask and tell, dedup and the seen
table, the best-so-far updates."""


def read(run):
    t = run.trace
    if t is None:
        return None
    scan = run.facts["scan_kernel"]
    other = [k for k in t.kernels() if scan not in k.name]
    if not other:
        return None
    total_us = sum(k.end_us - k.start_us for k in other)
    return total_us / 1e3 / (t.calls * run.facts["generations"])

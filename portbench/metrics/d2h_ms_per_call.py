"""Device time of the copies from the device to the host, in ms a
traced call: the outputs a call hands back (the per-generation curves
among them) and any value the host loop reads; nothing where the trace
holds no such copy."""


def read(run):
    t = run.trace
    if t is None:
        return None
    copies = [o for o in t.ops if o.is_to_host]
    if not copies:
        return None
    return sum(o.end_us - o.start_us for o in copies) / 1e3 / t.calls

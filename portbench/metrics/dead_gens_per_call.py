"""Generations a traced call stepped after every one of its runs had
stopped, a call; nothing where the program has no such counter."""
from portbench import phases


def read(run):
    c = phases.counters(run)
    if c is None or not c["calls"]:
        return None
    return c["dead_gens"] / c["calls"]

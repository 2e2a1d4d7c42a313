"""The 90th percentile of the calls' walls, from a call to its outputs
on the host, in ms: the nearest rank, the smallest wall that at least
90 % of the window's calls do not exceed."""
import math


def p90(values) -> float:
    ordered = sorted(values)
    return ordered[math.ceil(0.9 * len(ordered)) - 1]


def read(run):
    return p90([(end - start) * 1e3 for start, end, _ in run.calls])

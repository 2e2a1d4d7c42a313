"""The share of the traced calls' run-generations whose run had not stopped
at the generation's start, in %: the rest step runs whose budget is
spent, which commit nothing; nothing where the program has no such
counter."""
from portbench import phases


def read(run):
    c = phases.counters(run)
    if c is None or not c["run_gens"]:
        return None
    return 100.0 * c["live_run_gens"] / c["run_gens"]

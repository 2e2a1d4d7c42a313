"""Tokens of every call, prompt and generated, over the window's wall:
from the first call's start to the last one's end (host clock). Read
only where a call's work is tokens (the driver's ``work_unit``)."""


def read(run):
    if run.facts.get("work_unit") != "tokens":
        return None
    start, end = run.calls[0][0], run.calls[-1][1]
    return sum(work for _, _, work in run.calls) / (end - start)

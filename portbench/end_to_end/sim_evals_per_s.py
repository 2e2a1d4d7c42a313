"""Fresh simulated evaluations committed by every run of every call,
over the window's wall: from the first call's start to the last one's
end (host clock)."""


def read(run):
    start, end = run.calls[0][0], run.calls[-1][1]
    return sum(work for _, _, work in run.calls) / (end - start)

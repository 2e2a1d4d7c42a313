"""The whole step's share of the card's peak, in %: the model FLOPs of
every call of the window (``flops_per_call``, counted by the
configuration's own ``flops`` file: only the work the model must do),
over the window's wall (host clock) times the dense bf16 peak. Read
only where a call's work is tokens and the driver gives its FLOPs. A
reading over 100 % marks the count wrong; nothing clips it."""
from portbench.reference import peaks


def read(run):
    f = run.facts
    if f.get("work_unit") != "tokens" or "flops_per_call" not in f:
        return None
    start, end = run.calls[0][0], run.calls[-1][1]
    flops = f["flops_per_call"] * len(run.calls)
    return 100.0 * flops / ((end - start) * peaks.BF16_FLOPS_PER_S)

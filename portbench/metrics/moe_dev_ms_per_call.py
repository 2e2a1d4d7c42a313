"""Device time of the kernels launched inside the served model's ``lm.moe``
spans (each layer's norm, router, dispatch, held experts, combine,
shared expert and residual add), in ms a traced call; nothing where the
trace holds no such span."""
from portbench import lm_phases


def read(run):
    return lm_phases.dev_ms_per_call(run, "lm.moe")

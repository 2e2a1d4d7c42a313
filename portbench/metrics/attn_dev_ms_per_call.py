"""Device time of the kernels launched inside the served model's
``lm.attn`` spans (each attention layer's norm, q/k/v projections, flash
attention (prefill) or the plain decode, o_proj and residual add), in ms
a traced call; nothing where the trace holds no such span."""
from portbench import lm_phases


def read(run):
    return lm_phases.dev_ms_per_call(run, "lm.attn")

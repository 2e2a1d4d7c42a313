"""Device time of the kernels launched inside the served model's
``lm.mamba`` spans (each Mamba-2 layer's norm, in_proj, conv, SSD scan,
gated norm, out_proj and residual add (prefill and decode)), in ms a
traced call; nothing where the trace holds no such span."""
from portbench import lm_phases


def read(run):
    return lm_phases.dev_ms_per_call(run, "lm.mamba")

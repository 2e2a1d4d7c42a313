"""Set-up: from the start of the process to the end of the warm-up call
(imports, the CUDA context, the kernel's build or load, the recording's
load and the space's compile, one call at the cell's shapes)."""


def read(run):
    return run.setup_s

"""The peak of device memory allocated by the run up to the end of the
window (``torch.cuda.max_memory_allocated``), in GiB."""


def read(run):
    if not run.memory_peak_bytes:
        return None
    return run.memory_peak_bytes / 2 ** 30

"""The SSD scan's share of its roofline, in %: the least time its traced
calls could take by their operations at the card's float32 rate
(``reference/ssd_flops.py``, the three passes on the CUDA cores), over
the device time of its three kernels in the trace; nothing where the
trace holds no such kernel or the program records no scans."""
from portbench import lm_phases
from portbench.reference import ssd_flops


def read(run):
    t = run.trace
    c = lm_phases.counters(run)
    if t is None or c is None or not c.get("ssd_scans"):
        return None
    kernels = [k for k in t.kernels()
               if any(n in k.name for n in lm_phases.SSD_KERNELS)]
    if not kernels:
        return None
    device_s = sum(k.end_us - k.start_us for k in kernels) / 1e6
    least = sum(ssd_flops.chunked_flops(*shape)
                for shape in c["ssd_scans"]) / ssd_flops.F32_FLOPS_PER_S
    return 100.0 * least / device_s

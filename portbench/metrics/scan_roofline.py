"""The budget scan's share of its roofline, in %: the least time its
launches could take by the bytes they move at the HBM rate
(``reference/scan_bytes.py``), over their device time in the trace."""
from portbench.reference import scan_bytes


def read(run):
    t = run.trace
    if t is None:
        return None
    f = run.facts
    scans = [k for k in t.kernels() if f["scan_kernel"] in k.name]
    if not scans:
        return None
    device_s = sum(k.end_us - k.start_us for k in scans) / 1e6
    least = scan_bytes.least_seconds(f["runs"], f["popsize"], f["n_valid"])
    return 100.0 * least * len(scans) / device_s

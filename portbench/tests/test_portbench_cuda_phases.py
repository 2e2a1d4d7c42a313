"""On the card: a traced ``free_run`` call of each cell at a small R, its
kernels put down to the program's spans, and its outputs as untraced.

    python -m pytest -c portbench/pytest.ini portbench/tests -m cuda

Each cell's call runs in a process of its own, under one profiler
session, as a traced run of the benchmark does (``python
portbench/tests/test_portbench_cuda_phases.py <cell>`` prints what the
test reads). Each test decides inside itself whether a card is there."""
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = ("gemm.ga", "hotspot.pso", "gemm.random", "hotspot.de")
LEAVES = {"free_run.init", "free_run.ask", "free_run.dedup",
          "free_run.scan", "free_run.tell", "free_run.commit",
          "free_run.to_host"}
SEED = 2 ** 31 + 11


def innermost(spans, t):
    """The innermost of ``spans`` (start, end, name) running at ``t``."""
    best = None
    for s, e, n in spans:
        if s <= t <= e and (best is None or (s, -e) > best[:2]):
            best = (s, -e, n)
    return best and best[2]


def correlated(prof) -> list:
    """From the profiler's raw events, in the order the kernels started:
    the innermost program span around the host operation that the
    profiler links each kernel to."""
    from torch.autograd import DeviceType

    from portbench import phases
    from portbench.trace import SPAN
    host, spans, kernels = {}, [], []
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns()
        if e.device_type() == DeviceType.CPU:
            if e.linked_correlation_id() == 0:
                host[e.correlation_id()] = start
            if phases.is_span(name):
                spans.append((start, start + e.duration_ns(), name))
        elif not (name == SPAN or phases.is_span(name)
                  or name.startswith(("Memcpy", "Memset"))):
            kernels.append((start, e.linked_correlation_id()))
    return [innermost(spans, host[c]) if c in host else None
            for _, c in sorted(kernels)]


def main(cell: str) -> dict:
    """One untraced and one traced call of ``cell`` at 2,048 runs."""
    import numpy as np

    from portbench import harness, phases
    from portbench.trace import Tracer
    c = harness.load_cell(ROOT, cell)
    d = harness.load_module(harness.PKG / "drivers" / "free_run.py",
                            "free_run").Driver(
        c.config, {**c.workload, "runs": 2048}, "cuda", ROOT)
    d.setup(harness.call_seed(1, harness.WARM_CALL))
    plain, _ = d.call(SEED)
    tracer = Tracer(1)
    tracer.start()
    with tracer.around():
        got, _ = d.call(SEED)
    tracer.stop()
    device_spans = sorted({e.name for e in tracer.prof.events()
                           if e.device_type.name != "CPU"
                           and phases.is_span(e.name)})
    p = phases.of(tracer.summary())
    return {"identical": all(np.array_equal(plain[k], got[k])
                             for k in plain),
            "device_spans": device_spans,
            "gens": sum(n == "free_run.gen" for _, _, n in p.spans),
            "by_launch": (None if p.by_kernel is None
                          else [n for _, n in p.by_kernel]),
            "by_correlation": correlated(tracer.prof)}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_every_kernel_of_a_traced_call_falls_in_one_leaf(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the budget scan has no CPU kernel")
    proc = subprocess.run([sys.executable, __file__, cell], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["identical"]
    # the spans are host ranges: the profiler mirrors none on the device
    assert got["device_spans"] == []
    assert got["gens"] == 100
    assert got["by_launch"] is not None, "launches and kernels disagree"
    assert set(got["by_launch"]) <= LEAVES
    # the launch order is the profiler's own link of each kernel to the
    # host operation that launched it
    assert got["by_launch"] == got["by_correlation"]


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    print(json.dumps(main(sys.argv[1])))

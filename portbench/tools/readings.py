"""The readings a cell's limits are set from, at the cell's own size.

    python3 portbench/tools/readings.py --workload gemm.ga \
        --seeds 101,102,103 [--control 3] [--fault state_unchanged ...]

In one process on the card: sets the cell's driver up once, then for
every seed runs one call of the program and the plain reference on that
call's sampled runs, and prints the program's reading (the lower one).
With ``--control n`` it also runs, on the first n seeds, the reference
in float32 spend, the control, and prints its reading against the
float64 reference (the upper one); with ``--fault`` each named fault of
``faults.py`` is planted under the program's call and its reading
printed. One JSON line a reading.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def main(argv) -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch

    from portbench import harness
    from portbench.reference import compare
    from portbench.tools import faults
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--fault", action="append", default=[],
                   choices=sorted(faults.FAULTS))
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    cell = harness.load_cell(ROOT, a.workload)
    wl = cell.workload
    driver = harness.load_module(
        harness.PKG / "drivers" / f"{wl['driver']}.py", wl["driver"]).Driver(
            cell.config, wl, a.device, ROOT)
    driver.setup(harness.call_seed(0, harness.WARM_CALL))
    card = torch.cuda.get_device_name(0) if a.device != "cpu" else "cpu"
    for n, seed in enumerate(int(s) for s in a.seeds.split(",")):
        s = harness.call_seed(seed, 0)
        sides = [("program", contextlib.nullcontext())]
        sides += [(f, faults.FAULTS[f](wl["strategy"])) for f in a.fault]
        want = None
        for side, ctx in sides:
            t0 = time.perf_counter()
            with ctx:
                got, _ = driver.call(s)
            wall = time.perf_counter() - t0
            if want is None:
                t1 = time.perf_counter()
                want = driver.reference([s])[0]
                ref_s = time.perf_counter() - t1
            print(json.dumps({"cell": a.workload, "seed": seed, "side": side,
                              "call_s": wall, "ref_s": ref_s, "card": card,
                              **compare.compare(got, want)}), flush=True)
        if n < a.control:
            low = driver.reference([s], spend_dtype=np.float32)[0]
            print(json.dumps({"cell": a.workload, "seed": seed,
                              "side": "control_float32", "card": card,
                              **compare.compare(low, want)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

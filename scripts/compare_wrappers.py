#!/usr/bin/env python3
"""Phase 7's prefill and phase 4's framework-kernel recordings of two
trees, in turns, on one card.

    python3 scripts/compare_wrappers.py --other build/parent

Runs ``chip_smoke.serve`` (phase 7: zamba2-1.2b at full width, 4 x 1024
prompts) and ``chip_smoke.record`` of flash attention and the SSD at
their phase-4 problems (every config of their spaces, 3 repeats) for
this tree and for ``--other`` (a checkout, e.g. ``git archive`` of the
parent unpacked under ``build/``), in the order other, this, this,
other, each in a fresh process that builds its own tree's kernels. It
prints, per run, the prefill ms and decode ms a token that phase 7
reports and each recording's median, min and max time a config, so a
change to the kernels' call path shows beside the runs' own spread.
Needs a card.
"""
import argparse
import json
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]

ONE = r"""
import json, pathlib, subprocess, sys, tempfile
tree = pathlib.Path(sys.argv[1])
sys.path[:0] = [str(tree), str(tree / "src")]
import torch
import chip_smoke as cs
from repro_torch import cuda
from repro_torch.core.cache import CacheFile
cuda.build()
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip()
cs.serve("cuda", smi, cs.SERVE_LIMIT_S)
out = pathlib.Path(tempfile.mkdtemp())
times = {}
for name in ("flash_attention", "ssd"):
    cache, path = cs.record(out, "cuda", name, cs.HUB_PROBLEMS[name],
                            cs.RECORD_EVALS[name], cs.RECORD_SECONDS[name])
    times[name] = sorted(r.time_s for r in cache.results.values()
                         if r.status == "ok")
print("RECORDED " + json.dumps(times))
"""


def run(tree: pathlib.Path) -> dict:
    got = subprocess.run([sys.executable, "-c", ONE, str(tree)],
                         capture_output=True, text=True, timeout=900)
    if got.returncode:
        sys.exit(f"{tree}: exit {got.returncode}\n{got.stdout[-3000:]}"
                 f"\n{got.stderr[-3000:]}")
    line = next(l for l in got.stdout.splitlines()
                if l.startswith("RECORDED "))
    rec = json.loads(line[len("RECORDED "):])
    m = re.search(r"\(e\) \[[^\]]*\] prefill ([0-9.]+) ms; decode "
                  r"([0-9.]+)", got.stdout)
    events = re.search(r"\(e\) \[[^\]]*\] prefill ([0-9.]+) ms \(CUDA "
                       r"events", got.stdout)
    return {"prefill_ms": float(m.group(1)), "decode_ms": float(m.group(2)),
            "prefill_events_ms": float(events.group(1)) if events else None,
            **{k: (statistics.median(v), v[0], v[-1]) for k, v in
               rec.items()}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other tree (its src/ and "
                         "chip_smoke.py)")
    args = ap.parse_args()
    other = pathlib.Path(args.other).resolve()
    for label, tree in (("other", other), ("this", ROOT), ("this", ROOT),
                        ("other", other)):
        r = run(tree)
        print(f"{label:5s} prefill {r['prefill_ms']:.3f} ms (engine), "
              f"{r['prefill_events_ms']} ms (CUDA events, median of 5), "
              f"decode "
              f"{r['decode_ms']:.3f} ms a token; recorded s a config "
              f"(median, min, max): flash_attention "
              f"{r['flash_attention']}, ssd {r['ssd']}", flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Phase 7's prefill and phase 4's framework-kernel recordings of two
trees, in turns, on one card.

    python3 scripts/compare_wrappers.py --other build/parent

Runs ``chip_smoke.serve`` (phase 7: zamba2-1.2b at full width, 4 x 1024
prompts) and ``chip_smoke.record`` of flash attention and the SSD at
their phase-4 problems (every config of their spaces, 3 repeats) for
this tree and for ``--other`` (a checkout, e.g. ``git archive`` of the
parent unpacked under ``build/``), in ``compare_trees.py``'s order
(other, this, this, other), each in a fresh process that builds its own
tree's kernels. It prints, per run, the prefill ms and decode ms a token that phase 7 reports and each
recording's median, min and max time a config, then each tree's median
and range of those, so a change to the kernels' call path shows beside
the runs' own spread. Needs a card.
"""
import argparse
import pathlib
import re
import statistics
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from compare_trees import in_turns, result, run_child  # noqa: E402

ONE = r"""
import contextlib, io, json, pathlib, subprocess, sys, tempfile
tree = pathlib.Path(sys.argv[1])
sys.path[:0] = [str(tree), str(tree / "src")]
import torch
import chip_smoke as cs
from repro_torch import cuda
cuda.build()
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip()
said = io.StringIO()
with contextlib.redirect_stdout(said):
    cs.serve("cuda", smi, cs.SERVE_LIMIT_S)
out = pathlib.Path(tempfile.mkdtemp())
times = {}
for name in ("flash_attention", "ssd"):
    cache, path = cs.record(out, "cuda", name, cs.HUB_PROBLEMS[name],
                            cs.RECORD_EVALS[name], cs.RECORD_SECONDS[name])
    times[name] = sorted(r.time_s for r in cache.results.values()
                         if r.status == "ok")
print(said.getvalue())
print("RESULT " + json.dumps(times))
"""


def measure(label: str, tree: pathlib.Path, first: bool) -> dict:
    said = run_child(ONE, str(tree))
    m = re.search(r"\(e\) \[[^\]]*\] (?:\w+ path: )?prefill ([0-9.]+) "
                  r"ms; decode ([0-9.]+)", said)
    out = {"prefill ms": float(m.group(1)),
           "decode ms a token": float(m.group(2))}
    events = re.search(r"\(e\) \[[^\]]*\] prefill ([0-9.]+) ms \(CUDA "
                       r"events", said)
    if events:
        out["prefill ms (CUDA events)"] = float(events.group(1))
    for name, v in result(said).items():
        out[f"{name} ms a config median"] = statistics.median(v) * 1e3
        out[f"{name} ms a config min"] = v[0] * 1e3
        out[f"{name} ms a config max"] = v[-1] * 1e3
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other tree (its src/ and "
                         "chip_smoke.py)")
    args = ap.parse_args()
    in_turns(pathlib.Path(args.other), 2, measure)


if __name__ == "__main__":
    main()

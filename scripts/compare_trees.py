#!/usr/bin/env python3
"""The host-bound serving paths of two trees, in turns, on one card.

    python3 scripts/compare_trees.py --other build/parent [--rounds 3]
        [--profile DIR]

Serves, in a fresh process for each run, what ``chip_smoke.py`` phases 7
and 9 serve, at the same shapes and with the same seeds, through the
tree's own ``repro_torch`` (its ``src/``, its kernels built from its own
sources):

  * zamba2-1.2b, 4 prompts of 1024 tokens, 32 new each (phase 7): the
    engine's prefill ms and decode ms a token, and one decode step timed
    alone (CUDA events, median of 7, and the host's wall until it
    returns);
  * whisper-small, 4 x 256, 32 new (phase 9 (a)): prefill ms and decode
    ms a token;
  * qwen2-vl-2b, 4 x 1024, 32 new (phase 9 (c)): prefill ms and decode ms
    a token;
  * the host's cost of one small op (2,000 in-place adds to a 4-element
    tensor on the card, median of 5), as ``chip_smoke.py`` phase 7 (c)
    prints it.

Each model is served once to warm up, then ``GENERATES`` times; a run
reports the medians. The runs alternate other, this, this, other, other,
this, ... (``--rounds`` of each), so a drift of the card's host shows in
both trees alike. The last lines give each tree's median and range of
the runs' medians. With ``--profile DIR`` each tree's first run also
writes cProfile tables (by own time) of five zamba2-1.2b decode steps and
one whisper-small prefill to ``DIR/<label>.txt``, each headed by its
Python calls and the ops it dispatches (counted by a
``TorchDispatchMode`` on a second run): counts the host's speed does not
move. Needs a card; imports nothing of the trees here, only in the runs.
"""
import argparse
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
GENERATES = 3

ONE = r"""
import cProfile, io, json, pathlib, pstats, statistics, sys, time
tree, generates = pathlib.Path(sys.argv[1]), int(sys.argv[2])
profile = sys.argv[3]
sys.path.insert(0, str(tree / "src"))
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch import cuda
cuda.build()
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch.configs import get_config
from repro_torch.inference.engine import Request, ServingEngine, family_inputs
from repro_torch.models import transformer as tf

dev = "cuda"
out, tables = {}, []
x = torch.zeros(4, device=dev)
op = []
for _ in range(5):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        x.add_(1)
    op.append((time.perf_counter() - t0) / 2000 * 1e6)
torch.cuda.synchronize()
out["small op host us"] = statistics.median(op)


def model_of(name):
    cfg = get_config(name)
    model = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    return cfg, model


def prompts(cfg, b, s):
    gen = torch.Generator(device=dev).manual_seed(1)
    return torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)


def served(key, cfg, model, tokens, new, max_len):
    engine = ServingEngine(cfg, model, max_len=max_len)
    reqs = [Request(prompt=row, max_new_tokens=new) for row in tokens.tolist()]
    engine.generate(reqs)
    pre, dec = [], []
    for _ in range(generates):
        engine.generate(reqs)
        t = engine.timings
        pre.append(t["prefill_ms"])
        dec.append(t["decode_ms"] / t["steps"])
    out[key + " prefill ms"] = statistics.median(pre)
    out[key + " decode ms a token"] = statistics.median(dec)


class Ops(TorchDispatchMode):
    n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        Ops.n += 1
        return func(*args, **(kwargs or {}))


def profiled(what, fn):
    prof = cProfile.Profile()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    Ops.n = 0
    with Ops():
        fn()
    torch.cuda.synchronize()
    text = io.StringIO()
    stats = pstats.Stats(prof, stream=text)
    stats.sort_stats("tottime").print_stats(30)
    tables.append(f"== {what}: {stats.total_calls} Python calls, {Ops.n} "
                  f"dispatched ops\n{text.getvalue()}")


cfg, model = model_of("zamba2-1.2b")
tokens = prompts(cfg, 4, 1024)
served("zamba2-1.2b", cfg, model, tokens, 32, 2048)
with torch.inference_mode():
    _, cache, n = tf.prefill(cfg, model, {"tokens": tokens}, 2048)
    pos = torch.full((4,), n, device=dev)

    def step():
        return tf.decode_step(cfg, model, cache, tokens[:, -1:], pos)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    times, host = [], []
    for _ in range(7):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        step()
        host.append((time.perf_counter() - t0) * 1e3)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    out["zamba2-1.2b decode step ms"] = statistics.median(times)
    out["zamba2-1.2b decode step host ms"] = statistics.median(host)
    if profile:
        profiled("zamba2-1.2b: five decode steps",
                 lambda: [step() for _ in range(5)])
del model, cache
torch.cuda.empty_cache()

cfg, model = model_of("whisper-small")
tokens = prompts(cfg, 4, 256)
served("whisper-small", cfg, model, tokens, 32, 448)
if profile:
    batch = {"tokens": tokens, **family_inputs(cfg, 4, 256, dev)}
    with torch.inference_mode():
        profiled("whisper-small: one prefill",
                 lambda: tf.prefill(cfg, model, batch, 448))
del model
torch.cuda.empty_cache()

cfg, model = model_of("qwen2-vl-2b")
served("qwen2-vl-2b", cfg, model, prompts(cfg, 4, 1024), 32, 2048)
if profile:
    pathlib.Path(profile).write_text("\n".join(tables))
print("RESULT " + json.dumps(out))
"""


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def run_child(one: str, *argv: str) -> str:
    """The standard output of ``python -c one argv...`` in a fresh
    process; exits with its output's tail if it fails."""
    got = subprocess.run([sys.executable, "-c", one, *argv],
                         capture_output=True, text=True, timeout=900)
    if got.returncode:
        sys.exit(f"{argv[:1]}: exit {got.returncode}\n{got.stdout[-3000:]}"
                 f"\n{got.stderr[-3000:]}")
    return got.stdout


def result(stdout: str) -> dict:
    """The JSON object of a run's ``RESULT`` line."""
    line = next(l for l in stdout.splitlines() if l.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def in_turns(other: pathlib.Path, rounds: int, measure) -> None:
    """``measure(label, tree, first)`` -> {name: number} for this tree and
    ``other`` in the order other, this, this, other, other, this, ...
    (``rounds`` runs of each; ``first`` on a tree's first run); prints
    each run, then each tree's median and range of the runs' numbers."""
    trees = {"other": other.resolve(), "this": ROOT}
    order = [("other", "this", "this", "other")[i % 4]
             for i in range(2 * rounds)]
    smi = card()
    print(f"[{smi}] order {order}", flush=True)
    runs = {"other": [], "this": []}
    for label in order:
        r = measure(label, trees[label], not runs[label])
        runs[label].append(r)
        print(f"{label:5s} " + ", ".join(f"{k} {v:.3f}" for k, v in
                                         r.items()), flush=True)
    print(f"[{smi}] medians (and ranges) of the runs' numbers:")
    for key in runs["this"][0]:
        cells = []
        for label in ("other", "this"):
            vals = [r[key] for r in runs[label]]
            cells.append(f"{label} {statistics.median(vals):.3f} "
                         f"({min(vals):.3f}-{max(vals):.3f})")
        print(f"  {key}: " + "; ".join(cells))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other tree (its src/)")
    ap.add_argument("--rounds", type=int, default=3,
                    help="runs of each tree")
    ap.add_argument("--profile", default=None,
                    help="directory for each tree's cProfile tables")
    args = ap.parse_args()

    def measure(label, tree, first):
        profile = ""
        if args.profile and first:
            pathlib.Path(args.profile).mkdir(parents=True, exist_ok=True)
            profile = str(pathlib.Path(args.profile) / f"{label}.txt")
        return result(run_child(ONE, str(tree), str(GENERATES), profile))

    in_turns(pathlib.Path(args.other), args.rounds, measure)


if __name__ == "__main__":
    main()

"""Quickstart on the PyTorch/CUDA port: tune the tuner through the public
facade; the port's counterpart of ``examples/quickstart.py``.

Builds (once) the benchmark hub's two search spaces it scores on, the
GEMM and hotspot brute-forced through the TPU v5e cost model, into
``--hub-root``; runs a journaled exhaustive hyperparameter campaign of
PSO (Table III grid) through simulation mode, replayed by the budget-scan
kernel on the card; shows the score spread and the tuned configuration;
then drives the same search with a meta-strategy. Re-running resumes
from the journal.

Run: PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The same workflow, from the port's CLI:
    python -m repro_torch hypertune --strategy pso --kernels gemm,hotspot \\
        --devices tpu_v5e --repeats 10 --journal pso.jsonl
    python -m repro_torch report pso.jsonl
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch import cuda
from repro_torch.api import Hub, Tuner
from repro_torch.hub import storage

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS, DEVICES = ("gemm", "hotspot"), ("tpu_v5e",)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--hub-root", default=storage.DEFAULT_ROOT,
                    help="the hub to score on (built there if it lacks "
                         "the two spaces)")
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--journal",
                    default=os.path.join(HERE, "quickstart_torch_pso.jsonl"))
    args = ap.parse_args(argv)
    device = cuda.resolve_device(args.device)

    want = {f"{k}@{d}" for k in KERNELS for d in DEVICES}
    have = (set(storage.read_manifest(args.hub_root)["files"])
            if os.path.exists(os.path.join(args.hub_root, "manifest.json"))
            else set())
    if not want <= have:
        Hub.build(args.hub_root, kernels=KERNELS, devices=DEVICES,
                  device=device)

    tuner = Tuner(kernels=KERNELS, devices=DEVICES, hub_root=args.hub_root,
                  repeats=args.repeats, seed=0, device=device)
    with tuner:
        for s in tuner.scorers:
            print(f"space {s.name}: {s.n_total} configs, optimum "
                  f"{s.optimum * 1e3:.3f} ms, budget {s.budget_s:.0f} "
                  f"simulated s")

        # 1. exhaustive hyperparameter tuning (Eq. 4) of PSO (Table III
        #    grid), checkpointed after every configuration
        run = tuner.hypertune("pso", journal=args.journal)
        scores = np.array(run.hypertuning.scores)
        print(f"\n{len(scores)} hyperparameter configs: "
              f"best {scores.max():+.3f} / mean {scores.mean():+.3f} / "
              f"worst {scores.min():+.3f} (drive: {run.fuse})")
        print(f"best hyperparameters: {run.best_hyperparams}")
        print(f"simulated tuning cost {run.simulated_seconds / 3600:.1f} h "
              f"replayed in {run.wall_seconds:.1f} s wall "
              f"({run.speedup:,.0f}x vs live tuning)")

        # 2. the same search, driven by a meta-strategy
        meta = tuner.meta("pso", "dual_annealing", extended=False,
                          max_hp_evals=12)
        print(f"\nmeta-strategy found score {meta.score:+.3f} with only "
              f"{meta.n_evaluated} of {len(scores)} configs evaluated "
              f"({meta.simulated_seconds / 3600:.1f} simulated h)")


if __name__ == "__main__":
    main()

"""The paper's technique pointed at the framework itself (§Perf driver).

Port of ``src/repro/autotune/perf.py``. The distribution configuration of
a dry-run cell — layout policy, remat policy, microbatch count — is a
constrained discrete search space exactly like a kernel's tiling space.
One "measurement" traces the cell (``launch.dryrun.run_cell``) and returns
the roofline step-time bound:

    objective = max(compute_s, memory_s, collective_s)
    infeasible (status error) when peak memory per rank exceeds the budget

The hillclimb is executed by a registered strategy (with hyperparameters
tuned by the hypertuner) through a LiveRunner-style wrapper; every
evaluation is logged hypothesis-loop style to experiments/perf/.

What changed: the reference's ``HBM_BUDGET`` (16 GiB, a v5e chip) is the
``hbm_budget`` argument; the CLI takes the card's memory
(``torch.cuda.get_device_properties(device).total_memory``), so no TPU
memory size is a constant of the port. The roofline terms stay in the
frame ``roofline/analysis.py`` names. ``main()`` starts the fake world of
512 ranks before anything else, as the reference forces its 512 host
devices; importing starts none.

Usage:
  PYTHONPATH=src python -m repro_torch.autotune.perf --arch olmo-1b \\
      --shape train_4k --evals 12 [--strategy greedy_ils] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import random
import time

from ..configs import SHAPES
from ..core.budget import Budget
from ..core.runner import Runner
from ..core.searchspace import SearchSpace
from ..core.strategies import get_strategy
from ..core.tunable import tunables_from_dict


def dist_space(shape_kind: str) -> SearchSpace:
    if shape_kind == "train":
        tunables = tunables_from_dict({
            "layout": ("2d", "dp", "2d_seq"),
            "remat": ("none", "dots", "full"),
            "microbatches": (1, 2, 4, 8),
        })
    else:  # prefill/decode: no remat/microbatching
        tunables = tunables_from_dict({
            "layout": ("2d", "dp", "2d_seq"),
            "remat": ("none",),
            "microbatches": (1,),
        })
    return SearchSpace(tunables, (), name=f"dist[{shape_kind}]")


class CellRunner(Runner):
    """Live runner: one evaluation = a fake-world trace + roofline
    analysis. Peak memory per rank above ``hbm_budget`` bytes is an
    infeasible (status error) evaluation."""

    def __init__(self, arch: str, shape: str, mesh_kind: str,
                 budget: Budget, hbm_budget: float,
                 log_path: str | None = None, device=None):
        self.arch, self.shape, self.mesh_kind = arch, shape, mesh_kind
        self.hbm_budget = hbm_budget
        self.device = device
        self.records: list = []
        self.log_path = log_path
        super().__init__(dist_space(SHAPES[shape].kind), budget)

    def _evaluate(self, config) -> tuple:
        from ..launch.dryrun import run_cell
        d = self.space.as_dict(config)
        t0 = time.perf_counter()
        rec = run_cell(self.arch, self.shape, self.mesh_kind,
                       microbatches=d["microbatches"], remat=d["remat"],
                       layout=d["layout"], device=self.device)
        wall = time.perf_counter() - t0
        if rec["status"] != "ok":
            self.records.append({**d, "status": rec.get("status"),
                                 "error": rec.get("error", "")[:200]})
            self._flush()
            return math.inf, "error", wall
        rl = rec["roofline"]
        peak = rec["memory"]["peak_bytes_per_chip"]
        value = max(rl["compute_s"], rl["memory_s"], rl["collective_s"])
        status = "ok"
        if peak > self.hbm_budget:
            value, status = math.inf, "error"  # does not fit the memory
        self.records.append({
            **d, "status": "ok" if status == "ok" else "oom",
            "objective_s": None if value == math.inf else value,
            "compute_s": rl["compute_s"], "memory_s": rl["memory_s"],
            "collective_s": rl["collective_s"], "dominant": rl["dominant"],
            "peak_gib": round(peak / 2**30, 2), "compile_s": rec["compile_s"],
        })
        self._flush()
        return value, status, wall

    def _flush(self):
        if self.log_path:
            with open(self.log_path, "w") as f:
                json.dump(self.records, f, indent=1)


def hillclimb(arch: str, shape: str, mesh_kind: str = "single",
              strategy: str = "greedy_ils", max_evals: int = 12,
              seed: int = 0, out_dir: str = "experiments/perf",
              hyperparams: dict | None = None, *, hbm_budget: float,
              device=None) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    log_path = os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}.json")
    runner = CellRunner(arch, shape, mesh_kind, Budget(max_evals=max_evals),
                        hbm_budget, log_path, device)
    # baseline first (the paper-faithful starting point)
    baseline_cfg = runner.space.from_dict(
        {"layout": "2d", "remat": "full" if SHAPES[shape].kind == "train"
         else "none", "microbatches": 1})
    base = runner.run(baseline_cfg)
    strat = get_strategy(strategy, **(hyperparams or {}))
    best = strat.run(runner.space, runner, random.Random(seed))
    result = {
        "arch": arch, "shape": shape, "mesh": mesh_kind,
        "baseline": {"config": runner.space.as_dict(baseline_cfg),
                     "objective_s": base.value},
        "best": {"config": runner.space.as_dict(best.config),
                 "objective_s": best.value},
        "improvement": (base.value / best.value
                        if best and math.isfinite(best.value) else None),
        "evaluations": runner.records,
    }
    with open(os.path.join(out_dir,
                           f"{arch}__{shape}__{mesh_kind}_summary.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None) -> None:
    # the cells trace against 512 ranks of a fake world: started here, on
    # the CLI path only (see launch.dryrun)
    from .. import cuda
    from ..launch.mesh import init_fake_world
    init_fake_world(512)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--strategy", default="greedy_ils")
    ap.add_argument("--evals", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="the mesh's device; the card unless 'cpu'")
    ap.add_argument("--hbm-budget", type=float, default=None,
                    help="bytes a rank may hold (default: the card's "
                         "memory; required with --device cpu)")
    args = ap.parse_args(argv)
    device = cuda.resolve_device(args.device)
    budget = args.hbm_budget
    if budget is None:
        if device == "cpu":
            ap.error("--hbm-budget is required with --device cpu")
        import torch
        budget = torch.cuda.get_device_properties(device).total_memory
    res = hillclimb(args.arch, args.shape, args.mesh,
                    strategy=args.strategy, max_evals=args.evals,
                    hbm_budget=budget, device=device)
    print(json.dumps({k: v for k, v in res.items() if k != "evaluations"},
                     indent=1))


if __name__ == "__main__":
    main()

"""Auto-tune the hand-written GEMM's tiling with a tuned optimization
strategy, then check the winning tiling against the plain version: the
PyTorch/CUDA port's counterpart of ``examples/autotune_kernel.py``.

The tuning run goes through the ask/tell ``SearchDriver``: greedy ILS (the
hyperparameters the hypertuner found) proposes tilings, the cost model of
a TPU v5e scores the ones the card's kernel can run (``gemm.fits`` at
bf16; the others are rejected before any evaluation, as a live recording
rejects them), the driver owns the budget, the trace and the RNG. It
scores only tilings whose capped form (below) the kernel runs at the
check's shape in both dtypes, so the check never skips one.

The check: on the card the winning tiling (capped at 256, on a 512^3
problem) runs through the hand-written CUDA kernel, in float32 and in
bf16, held against ``gemm_plain``; on the CPU (``--device cpu``) the
wrapper runs ``gemm_plain`` itself, held against a float64 product.

Run: PYTHONPATH=src python examples/torch_autotune_kernel.py [--device cpu]
"""
import argparse
import os
import random
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch import cuda
from repro_torch.core.budget import Budget
from repro_torch.core.cache import CachedResult
from repro_torch.core.devices import V5E
from repro_torch.core.driver import SearchDriver
from repro_torch.core.runner import INVALID, CostModelRunner
from repro_torch.core.strategies import get_strategy
from repro_torch.kernels import gemm

M = N = K = 512
CAP = 256                                          # a tile at most 256
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}  # tests/test_kernels.py


def checked(cfg) -> dict:
    """The tiling the check runs: ``cfg``'s blocks capped at ``CAP``."""
    return {k: min(cfg[k], CAP) for k in ("block_m", "block_n", "block_k")}


class FittingRunner(CostModelRunner):
    """The cost model on the tilings the card's kernel can run at the hub
    shape in bf16, and whose capped form it runs at the check's shape in
    both dtypes; the rest are rejected, as a live recording rejects them
    before launch."""

    def _evaluate(self, config):
        cfg = self.space.as_dict(config)
        if not gemm.fits(cfg, torch.bfloat16) or any(
                gemm.plan(checked(cfg), M, N, K, dt) is None for dt in TOL):
            return CachedResult("error", INVALID, (), 0.0)
        return super()._evaluate(config)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = cuda.resolve_device(args.device)

    space = gemm.space()
    runner = FittingRunner(space, gemm.workload(), V5E,
                           Budget(max_evals=150))
    strategy = get_strategy("greedy_ils", perturbation=2,
                            restart_chance=0.05)
    best = SearchDriver(strategy, space, runner, random.Random(0)).run()
    cfg = space.as_dict(best.config)
    print(f"tuned gemm tiling: {cfg}  modelled {best.value * 1e3:.3f} ms "
          f"({runner.fresh_evals} evaluations)")

    tiling = checked(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    for dtype in TOL:
        a, b, c0 = (torch.randn(shape, generator=gen, device=device).to(
            dtype) for shape in ((M, K), (K, N), (M, N)))
        if gemm.plan(tiling, M, N, K, dtype) is None:
            raise SystemExit(f"{dtype}: the winning tiling {tiling} does "
                             f"not fit the kernel at {M}^3")
        out = gemm.gemm(a, b, c0, **tiling).float()
        if device == "cpu":
            ref = (a.double() @ b.double() + c0.double()).float()
            what = "gemm_plain against a float64 product"
        else:
            ref = gemm.gemm_plain(a, b, c0).float()
            what = "the CUDA kernel against gemm_plain"
        err = ((out - ref).abs() / (ref.abs() + K ** 0.5)).max().item()
        print(f"{dtype} {tiling}: {what}, max relative error {err:.3g} "
              f"(limit {TOL[dtype]})")
        if not err <= TOL[dtype]:
            raise SystemExit(f"the winning tiling disagrees at {dtype}")
    print(f"winning configuration checked on {device}")


if __name__ == "__main__":
    main()

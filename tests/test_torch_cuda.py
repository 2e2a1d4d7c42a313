"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card (a CUDA kernel has no CPU mode): they are
marked ``cuda`` and skip with a reason without one. The file imports only
``repro_torch`` (no jax), so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py

Tolerances: the GEMM ``RTOL[dtype]·√k`` of tests/test_kernels.py (the
kernel sums over K in another order than the plain float32 matmul); the
budget scan and the replay engine none — bit-identical.
"""
import random

import numpy as np
import pytest
import torch

from repro_torch.core import engine_torch
from repro_torch.core.budget import Budget
from repro_torch.core.cache import CachedResult, CacheFile
from repro_torch.core.methodology import evaluate_strategy, make_scorer
from repro_torch.core.runner import SimulationRunner
from repro_torch.core.searchspace import SearchSpace
from repro_torch.core.strategies import get_strategy
from repro_torch.core.tunable import tunables_from_dict
from repro_torch.kernels import gemm as gm

pytestmark = pytest.mark.cuda

RTOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
SHAPES = [  # tests/test_kernels.py's sweep
    (128, 128, 128, 64, 128, 128),
    (192, 256, 320, 96, 128, 64),
    (200, 130, 90, 64, 128, 128),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return "cuda"


def _cache() -> CacheFile:
    """A small cache with failures and varied charges, made from a seed."""
    space = SearchSpace(tunables_from_dict({"a": tuple(range(24)),
                                            "b": tuple(range(4)),
                                            "m": ("p", "q")}), name="cuda")
    rng = np.random.default_rng(5)
    results = {}
    for i, conf in enumerate(space.valid_configs):
        if i % 11 == 3:
            results[space.config_id(conf)] = CachedResult(
                "error", float("inf"), (), float(rng.random()), 0.01)
        else:
            v = float(rng.random()) * 1e-3
            results[space.config_id(conf)] = CachedResult(
                "ok", v, (v, v), float(rng.random()) * 0.1, 0.01)
    return CacheFile("cuda", "synth", space, results)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k,bm,bn,bk", SHAPES)
def test_gemm_kernel_matches_plain(card, dtype, m, n, k, bm, bn, bk):
    rng = np.random.default_rng(0)
    a, b, c0 = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                .to(device=card, dtype=dtype)
                for s in ((m, k), (k, n), (m, n)))
    before = gm.launches
    out = gm.gemm(a, b, c0, block_m=bm, block_n=bn, block_k=bk, alpha=0.5,
                  beta=1.5)
    torch.cuda.synchronize()
    assert gm.launches == before + 1
    tol = RTOL[dtype] * k ** 0.5
    torch.testing.assert_close(out.float(), gm.gemm_plain(
        a, b, c0, alpha=0.5, beta=1.5).float(), rtol=tol, atol=tol)


def test_gemm_rejects_before_launch_on_card(card):
    x = torch.zeros(64, 64, dtype=torch.bfloat16, device=card)
    before = gm.launches
    with pytest.raises(gm.ConfigRejected):
        gm.gemm(x, x, x, block_m=512, block_n=1024, block_k=64)
    assert gm.launches == before


def test_budget_scan_kernel_bit_identical_to_plain(card):
    cache = _cache()
    compiled, cols = cache.space.compiled, cache.columns
    rng = np.random.default_rng(11)
    rows = np.stack([rng.permutation(compiled.n_valid) for _ in range(64)])
    total = float(cols.charge_s.sum())
    budgets = rng.random(64) * total
    before = engine_torch.replay.launches
    outs = [engine_torch.replay_many(cols, compiled, rows,
                                     max_seconds=budgets, device=dev)
            for dev in (card, "cpu")]
    assert engine_torch.replay.launches == before + 1
    for a, b in zip(*outs):
        assert torch.equal(a.cpu(), b)


def test_torch_engine_on_card_matches_numpy_engine(card):
    cache = _cache()
    for name in ("random_search", "genetic_algorithm"):
        reports = [evaluate_strategy(lambda: get_strategy(name),
                                     [make_scorer(cache, engine=engine,
                                                  device=card)],
                                     repeats=5, seed=1)
                   for engine in ("torch", "vectorized")]
        assert reports[0].score == reports[1].score
        assert np.array_equal(reports[0].curve, reports[1].curve)


def test_ga_generations_dispatch_on_card(card):
    cache = _cache()
    # GA restarts until its budget runs out: give it one that does
    runner = SimulationRunner(cache, Budget(max_evals=120), engine="torch",
                              device=card)
    get_strategy("genetic_algorithm", maxiter=3).run(
        cache.space, runner, random.Random(0))
    assert runner.torch_engine().dispatches > 1
    assert runner.device == card

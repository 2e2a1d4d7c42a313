"""The port's GEMM (``repro_torch.kernels.gemm``) against the reference.

On the CPU the wrapper takes the kernel's plain PyTorch version, held here
against the Pallas kernel of ``repro.kernels.gemm`` in interpret mode on
the same numpy-seeded operands, with the tolerance of
tests/test_kernels.py: ``RTOL[dtype]·√k`` (float32 sums in another order;
bf16 rounds the output once more). The CUDA kernel itself is compared with
the plain version on the card by chip_smoke.py and tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gemm as ref_gemm
from repro_torch import cuda
from repro_torch.core.budget import Budget
from repro_torch.core.runner import LiveRunner
from repro_torch.kernels import get_kernel
from repro_torch.kernels import gemm as gm

RTOL = {"float32": 2e-4, "bfloat16": 2e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
SHAPES = [  # tests/test_kernels.py's sweep
    (128, 128, 128, 64, 128, 128),
    (192, 256, 320, 96, 128, 64),
    (200, 130, 90, 64, 128, 128),
]


def _operands(m, n, k, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k), dtype=np.float32),
            rng.standard_normal((k, n), dtype=np.float32),
            rng.standard_normal((m, n), dtype=np.float32))


def _to_torch(xs, dtype, device="cpu"):
    return [torch.from_numpy(x).to(device=device, dtype=TORCH_DTYPE[dtype])
            for x in xs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,k,bm,bn,bk", SHAPES)
def test_plain_matches_pallas_interpret(dtype, m, n, k, bm, bn, bk):
    """Tolerance RTOL[dtype]·√k, as tests/test_kernels.py states."""
    a, b, c0 = _operands(m, n, k)
    ref = ref_gemm.gemm(*(jnp.asarray(x).astype(JAX_DTYPE[dtype])
                          for x in (a, b, c0)),
                        block_m=bm, block_n=bn, block_k=bk, alpha=0.5,
                        beta=1.5, interpret=True)
    out = gm.gemm_plain(*_to_torch((a, b, c0), dtype), alpha=0.5, beta=1.5)
    tol = RTOL[dtype] * k ** 0.5
    assert out.dtype == TORCH_DTYPE[dtype]
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrapper_on_cpu_takes_plain_version_without_launching(dtype):
    """Exact equality: on CPU tensors the wrapper is the plain version."""
    m, n, k, bm, bn, bk = SHAPES[1]
    xs = _to_torch(_operands(m, n, k, seed=3), dtype)
    before = gm.launches
    out = gm.gemm(*xs, block_m=bm, block_n=bn, block_k=bk, alpha=0.5,
                  beta=1.5)
    assert torch.equal(out, gm.gemm_plain(*xs, alpha=0.5, beta=1.5))
    assert gm.launches == before


def test_space_identical_to_reference():
    ours, ref = gm.space(), ref_gemm.space()
    assert ours.size == ref.size == 10140
    assert [t.name for t in ours.tunables] == [t.name for t in ref.tunables]
    assert [t.values for t in ours.tunables] == [t.values for t in ref.tunables]
    assert ours.valid_configs == ref.valid_configs
    assert [ours.config_id(c) for c in ours.valid_configs] == \
        [ref.config_id(c) for c in ref.valid_configs]
    assert gm.SMOKE_PROBLEM == ref_gemm.SMOKE_PROBLEM
    assert (gm.HUB_M, gm.HUB_N, gm.HUB_K) == (4096, 4096, 4096)


def test_workload_matches_reference():
    from repro.core.devices import HUB_DEVICES as REF_DEVICES
    from repro.core.costmodel import estimate as ref_estimate
    from repro_torch.core.costmodel import estimate
    from repro_torch.core.devices import DEVICES_BY_NAME
    space = gm.space()
    for conf in space.valid_configs[::997]:
        d = space.as_dict(conf)
        for dev in REF_DEVICES:
            ours = estimate(gm.workload(), d, DEVICES_BY_NAME[dev.name], "x")
            ref = ref_estimate(ref_gemm.workload(), d, dev, "x")
            assert (ours.status, ours.time_s, ours.compile_s) == \
                (ref.status, ref.time_s, ref.compile_s)


@pytest.mark.parametrize("conf,dtype,ok", [
    ((128, 128, 64), torch.bfloat16, True),
    ((96, 160, 48), torch.bfloat16, True),
    ((8, 64, 32), torch.float32, True),
    ((256, 128, 256), torch.bfloat16, True),     # 512 threads, 196,608 B
    ((256, 256, 64), torch.bfloat16, False),     # 1024 threads
    ((128, 128, 512), torch.bfloat16, False),    # 262,144 B of tiles
    ((128, 128, 384), torch.float32, False),     # float32 doubles the tiles
    ((128, 128, 384), torch.bfloat16, True),
])
def test_fits(conf, dtype, ok):
    bm, bn, bk = conf
    assert gm.fits({"block_m": bm, "block_n": bn, "block_k": bk}, dtype) is ok


def test_rejected_count_over_the_space():
    space = gm.space()
    confs = [space.as_dict(c) for c in space.valid_configs]
    rejected = sum(not gm.fits(c, torch.bfloat16) for c in confs)
    assert rejected == 7096  # of 10,140: 3,044 tilings run on the card


def test_config_rejected_before_launch_on_any_device():
    xs = _to_torch(_operands(64, 64, 64), "bfloat16")
    before = gm.launches
    with pytest.raises(gm.ConfigRejected):
        gm.gemm(*xs, block_m=512, block_n=1024, block_k=2048)
    assert issubclass(gm.ConfigRejected, ValueError)
    assert gm.launches == before


def test_live_runner_records_rejections_and_propagates_faults():
    """Only ConfigRejected (incl. a refused launch) is a failed config;
    any other exception — a sticky CUDA fault — must propagate."""
    space = gm.space()
    fn = get_kernel("gemm").make_live({"m": 32, "n": 64, "k": 32},
                                      device="cpu")
    runner = LiveRunner(space, fn, Budget(max_evals=10), repeats=1)
    bad = next(c for c in space.valid_configs
               if not gm.fits(space.as_dict(c), torch.bfloat16))
    good = next(c for c in space.valid_configs
                if gm.fits(space.as_dict(c), torch.bfloat16))
    assert runner.run(bad).status == "error"
    obs = runner.run(good)
    assert obs.status == "ok" and len(obs.result.times_s) == 1

    def refused(conf):
        raise cuda.LaunchRefused("launch refused")

    def fault(conf):
        raise RuntimeError("an illegal memory access was encountered")

    assert LiveRunner(space, refused, Budget(max_evals=1)).run(good) \
        .status == "error"
    with pytest.raises(RuntimeError, match="illegal memory access"):
        LiveRunner(space, fault, Budget(max_evals=1)).run(good)


def test_make_live_without_cuda_raises_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gm.make_live()
    gm.make_live(device="cpu")({"block_m": 128, "block_n": 128,
                                "block_k": 64})


def test_make_live_operands_are_seeded_bf16():
    fn_a = gm.make_live({"m": 16, "n": 64, "k": 32, "seed": 5}, device="cpu")
    cells = fn_a.__closure__
    tensors = [c.cell_contents for c in cells
               if isinstance(c.cell_contents, torch.Tensor)]
    assert {t.dtype for t in tensors} == {torch.bfloat16}
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((16, 32), dtype=np.float32))
    assert any(torch.equal(t, a.to(torch.bfloat16)) for t in tensors)


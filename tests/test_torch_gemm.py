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
    ((256, 128, 256), torch.bfloat16, True),     # 2 x 2 frags, 1 stage
    ((256, 256, 64), torch.bfloat16, False),     # 4 frags of 256 columns
    ((128, 128, 512), torch.bfloat16, False),    # 262,144 B in one stage
    ((128, 128, 384), torch.float32, False),     # float32 doubles the tiles
    ((128, 128, 384), torch.bfloat16, True),
    ((256, 256, 64), torch.float32, False),      # fma: 1024 threads
    ((8, 64, 2048), torch.bfloat16, False),      # one stage of 524,288 B
    ((192, 256, 64), torch.bfloat16, False),     # 3 x 64 x 256: 128 regs
    ((192, 128, 64), torch.bfloat16, True),      # 3 consumers of 64 x 128
    ((320, 64, 32), torch.bfloat16, False),      # 5 frags split over no 1-3
    ((384, 64, 32), torch.bfloat16, True),       # 6 frags: 3 consumers x 2
    ((64, 640, 32), torch.bfloat16, False),      # 4 x 160 over <= 3 consumers
])
def test_fits(conf, dtype, ok):
    bm, bn, bk = conf
    assert gm.fits({"block_m": bm, "block_n": bn, "block_k": bk}, dtype) is ok


def _plan(bm, bn, bk, m=4096, n=4096, k=4096, dtype=torch.bfloat16):
    return gm.plan({"block_m": bm, "block_n": bn, "block_k": bk}, m, n, k,
                   dtype)


@pytest.mark.parametrize("bm,rows,warpgroups,frags", [
    (8, 64, 1, 1),       # padded to one wgmma of 64 rows
    (48, 64, 1, 1),
    (96, 128, 2, 1),     # two 64-row slices, one a consumer
    (512, 512, 2, 4),    # eight slices: two consumers of four (N 64)
])
def test_plan_block_m(bm, rows, warpgroups, frags):
    pl = _plan(bm, 64, 32)
    assert (pl.path, pl.rows, pl.warpgroups, pl.frags, pl.wgmma_n,
            pl.pieces) == ("wgmma", rows, warpgroups, frags, 64, 1)
    assert pl.threads == 128 * (warpgroups + 1)


@pytest.mark.parametrize("bn,wgmma_n,pieces,fits_bm64", [
    (160, 160, 1, True),
    (640, 160, 4, False),    # 4 frags of 160 columns: no even split fits
    (896, 224, 4, False),    # 4 x 224 too
    (1024, 256, 4, False),
    (512, 256, 2, True),
    (768, 256, 3, False),    # three of 64 x 256 pass 128 registers
])
def test_plan_block_n(bn, wgmma_n, pieces, fits_bm64):
    assert gm._wgmma_split(bn) == (wgmma_n, pieces)
    pl = _plan(64, bn, 32)
    assert (pl is not None) is fits_bm64
    if pl is not None:
        assert (pl.wgmma_n, pl.pieces, pl.warpgroups * pl.frags) == \
            (wgmma_n, pieces, pieces)
        assert pl.frags * pl.wgmma_n <= gm.MAX_ACC_COLS
        assert pl.warpgroups < 3 \
            or pl.frags * pl.wgmma_n <= gm.MAX_ACC_COLS_3
        assert pl.swizzle_b == (128 if wgmma_n % 64 == 0 else 64)


@pytest.mark.parametrize("bk,swizzle_a,stages", [
    (48, 32, 4),         # 16-element K rows: 32-byte swizzle
    (96, 64, 4),
    (64, 128, 4),
    (768, 128, 1),       # (64 + 64) * 768 * 2 B: one stage
    (2048, None, None),  # no stage fits
])
def test_plan_block_k(bk, swizzle_a, stages):
    pl = _plan(64, 64, bk)
    if swizzle_a is None:
        assert pl is None
        return
    assert (pl.swizzle_a, pl.stages) == (swizzle_a, stages)
    assert stages * 128 * bk * 2 + gm.SMEM_RESERVED <= gm.MAX_SMEM_BYTES


def test_plan_one_stage_and_limits():
    pl = _plan(128, 128, 384)
    assert pl.stages == 1 and pl.warpgroups == 2
    assert 2 * 256 * 384 * 2 + gm.SMEM_RESERVED > gm.MAX_SMEM_BYTES
    assert _plan(128, 128, 64).stages == gm.MAX_STAGES
    # the grid's row dimension: at most 65,535 row tiles
    assert _plan(8, 64, 32, m=8 * 65535) is not None
    assert _plan(8, 64, 32, m=8 * 65535 + 1) is None
    # TMA boxes of at most 256 rows split block_m and block_k evenly
    assert _plan(520, 64, 32) is None and _plan(8, 64, 544) is None
    assert _plan(368, 64, 32).rows == 384 and _plan(8, 64, 528) is not None
    fma = _plan(64, 128, 128, dtype=torch.float32)
    assert (fma.path, fma.threads, fma.rows, fma.stages) == \
        ("fma", 128, 64, 1)


@pytest.mark.parametrize("m,n,k,padded", [
    (200, 130, 90, True),
    (256, 128, 96, False),
    (64, 64, 100, True),     # k alone
    (64, 66, 64, True),      # n alone
])
def test_plan_unaligned_shape(m, n, k, padded):
    assert _plan(64, 128, 128, m, n, k).padded is padded
    assert not _plan(64, 128, 128, m, n, k, dtype=torch.float32).padded


@pytest.mark.parametrize("m,n,k", [(200, 130, 90), (33, 64, 17), (8, 8, 8)])
def test_pad_operands_then_slice_is_the_product(m, n, k):
    """The padding is zeros, so each output element is the same float32
    sum of the same products plus zeros; 1e-5 allows the CPU's matmul to
    block the two lengths of K differently."""
    a, b, c0 = _to_torch(_operands(m, n, k, seed=7), "float32")
    pa, pb, pc = gm.pad_operands(a, b, c0)
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    assert pa.shape == (m, kp) and pb.shape == (kp, np_) \
        and pc.shape == (m, np_)
    assert torch.equal(pa[:, :k], a) and not pa[:, k:].any()
    assert torch.equal(pb[:k, :n], b) and not pb[k:].any() \
        and not pb[:, n:].any()
    out = gm.gemm_plain(pa, pb, pc, alpha=0.5, beta=1.5)[:, :n]
    np.testing.assert_allclose(
        out.numpy(), gm.gemm_plain(a, b, c0, alpha=0.5, beta=1.5).numpy(),
        rtol=1e-5, atol=1e-5)


def test_rejected_count_over_the_space():
    space = gm.space()
    confs = [space.as_dict(c) for c in space.valid_configs]
    rejected = sum(not gm.fits(c, torch.bfloat16) for c in confs)
    assert rejected == 7708  # of 10,140: 2,432 tilings run on the card


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


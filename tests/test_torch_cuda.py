"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card (a CUDA kernel has no CPU mode): they are
marked ``cuda`` and skip with a reason without one. The file imports only
``repro_torch`` (no jax), so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py

Tolerances: the GEMM ``RTOL[dtype]·√k`` of tests/test_kernels.py (the
kernel sums over K in another order than the plain float32 matmul);
hotspot, the convolution and dedispersion none — bit-identical
(``torch.equal``: hotspot's steps in ``_stencil_once``'s order, the
convolution's taps dy outer, dx inner, ``__fmul_rn`` then ``__fadd_rn``;
dedispersion's channel-order ``__fadd_rn``, as the plain versions
compute);
flash attention
``RTOL[dtype]`` (its card command: ``-k flash``) and the SSD scan 3e-3, tests/test_kernels.py's (online
softmax and chunked sums reorder the adds), its final state too; the
budget scan, the replay engine and fused campaigns none — bit-identical.
The model's call sites (``models/attention.py``, ``models/mamba2.py``)
run their kernels against the plain versions with the same tolerances,
and a tiny model on the card against the CPU within 0.05, the tolerance
tests/test_models.py gives the reference's prefill against its forward.
Training: the kernel's lse within float32 RTOL of the plain logsumexp
and the SSD's chunk states within 3e-3 of ``ssd_plain``'s (the outputs
bit-identical with and without them); the two call sites' autograd
Functions against autograd through the plain versions (output and input
gradients by relative error, RTOL of the dtype and 3e-3); one tiny train
step on the card against the CPU in float32 compute, the loss within 1e-4
and every parameter within 3e-5 (a tenth of the learning rate: AdamW's
first step moves each by about lr).
The hub on the card: the framework kernels' smoke recordings, a live
fleet and a live warm start launch their kernels exactly as often as
their recordings ran them (one warm-up and one a repeat an ok config).
The mesh tooling: the kernels' operators (``torch.ops.repro_torch.*``)
one launch a call and bit-identical to the direct launch, within the
kernels' tolerances of the plain versions; zamba2-1.2b at full width,
cut to 7 layers, on a one-rank ``nccl`` mesh with DTensor parameters
bit-identical to the plain calls (logits, loss, every gradient; no
tolerance: one rank runs the same local ops); a fake-world dry-run
cell at its published size on the card, launching nothing.
"""
import dataclasses
import random

import numpy as np
import pytest
import torch

from repro_torch.core import engine_torch
from repro_torch.core.budget import Budget
from repro_torch.core.cache import CachedResult, CacheFile
from repro_torch.core.driver import SearchDriver, drive_many
from repro_torch.core.engine_torch import campaign
from repro_torch.core.methodology import evaluate_strategy, make_scorer
from repro_torch.core.runner import SimulationRunner
from repro_torch.core.searchspace import SearchSpace
from repro_torch.core.strategies import get_strategy
from repro_torch.core.tunable import tunables_from_dict
from repro_torch.kernels import convolution as cv
from repro_torch.kernels import dedispersion as dd
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gemm as gm
from repro_torch.kernels import hotspot as hs
from repro_torch.kernels import ssd

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


# one tiling for each class of value the bf16 plan maps onto the hardware
# (kernels/gemm.py, ``plan``), at a shape that is ragged against every tile
WGMMA_CLASSES = [
    (8, 64, 32),       # block_m 8: rows padded to 64, one consumer
    (48, 256, 64),     # block_m 48, wgmma N 256
    (96, 160, 48),     # block_m 96 -> 128 rows; N 160; 32-byte swizzle
    (512, 64, 32),     # block_m 512: two TMA boxes of rows, 4 frags each
    (64, 512, 64),     # block_n 512 = 2 x 256
    (192, 128, 64),    # three consumers of 64 x 128
    (384, 64, 32),     # three consumers holding two fragments each
    (256, 96, 128),    # N 96, two fragments a consumer
    (128, 128, 384),   # one stage; block_k 384 = two TMA boxes of K
    (64, 64, 768),     # block_k 768 = three TMA boxes of K, one stage
]


@pytest.mark.parametrize("bm,bn,bk", WGMMA_CLASSES)
def test_gemm_wgmma_classes_match_plain(card, bm, bn, bk):
    m, n, k = 300, 520, 1000
    conf = {"block_m": bm, "block_n": bn, "block_k": bk}
    assert gm.plan(conf, m, n, k, torch.bfloat16) is not None
    rng = np.random.default_rng(2)
    a, b, c0 = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                .to(device=card, dtype=torch.bfloat16)
                for s in ((m, k), (k, n), (m, n)))
    before = gm.launches
    out = gm.gemm(a, b, c0, block_m=bm, block_n=bn, block_k=bk, alpha=0.5,
                  beta=1.5)
    torch.cuda.synchronize()
    assert gm.launches == before + 1
    tol = RTOL[torch.bfloat16] * k ** 0.5
    torch.testing.assert_close(out.float(), gm.gemm_plain(
        a, b, c0, alpha=0.5, beta=1.5).float(), rtol=tol, atol=tol)


def test_gemm_bf16_takes_unaligned_views(card):
    """TMA reads from 16-byte aligned addresses: contiguous views that
    start one element into their storage are copied first."""
    m, n, k = 128, 136, 96
    rng = np.random.default_rng(4)
    a, b, c0 = (torch.from_numpy(rng.standard_normal(r * c + 1,
                                                     dtype=np.float32))
                .to(device=card, dtype=torch.bfloat16)[1:].view(r, c)
                for r, c in ((m, k), (k, n), (m, n)))
    assert all(t.data_ptr() % 16 for t in (a, b, c0))
    out = gm.gemm(a, b, c0, block_m=64, block_n=128, block_k=64, alpha=0.5,
                  beta=1.5)
    torch.cuda.synchronize()
    tol = RTOL[torch.bfloat16] * k ** 0.5
    torch.testing.assert_close(out.float(), gm.gemm_plain(
        a, b, c0, alpha=0.5, beta=1.5).float(), rtol=tol, atol=tol)


def test_gemm_rejects_before_launch_on_card(card):
    x = torch.zeros(64, 64, dtype=torch.bfloat16, device=card)
    before = gm.launches
    with pytest.raises(gm.ConfigRejected):
        gm.gemm(x, x, x, block_m=512, block_n=1024, block_k=64)
    assert gm.launches == before


def _randn(rng, shape, card, scale=1.0):
    x = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
    return torch.from_numpy(x).to(card)


@pytest.mark.parametrize("h,w,fh,fw,sh,bw", [
    (64, 128, 5, 5, 32, 128),
    (96, 130, 3, 7, 48, 96),          # padded width: 4-byte copies
    (128, 256, 17, 17, 16, 128),      # hub filter size
    (200, 300, 17, 17, 48, 320),      # non-dividing in both dims
    # one case per instantiation class and ring depth of the plan
    (40, 52, 3, 3, 16, 96),           # fw 3
    (50, 70, 33, 33, 8, 96),          # fw 33: the run-time width
    (37, 45, 9, 9, 16, 128),          # the run-time width, 3 stages
    (200, 300, 17, 17, 96, 256),      # the hub filter, 3 stages
    (150, 200, 17, 17, 512, 4096),    # 512 threads, tile past the image
    (33, 259, 7, 7, 8, 96),           # odd width, 8-row tiles
    (64, 256, 4, 6, 32, 128),         # even filter sides
])
def test_conv_kernel_matches_plain(card, h, w, fh, fw, sh, bw):
    rng = np.random.default_rng(1)
    x, f = _randn(rng, (h, w), card), _randn(rng, (fh, fw), card)
    before = cv.launches
    out = cv.conv2d(x, f, strip_h=sh, block_w=bw)
    torch.cuda.synchronize()
    assert cv.launches == before + 1
    assert torch.equal(out, cv.conv2d_plain(x, f))


def test_conv_kernel_takes_a_misaligned_image(card):
    """An image whose storage starts 4 bytes past a 16-byte boundary: every
    row takes 4-byte copies."""
    rng = np.random.default_rng(2)
    h, w = 70, 128
    x = torch.empty(h * w + 1, device=card)[1:].view(h, w)
    x.copy_(_randn(rng, (h, w), card))
    f = _randn(rng, (17, 17), card)
    out = cv.conv2d(x, f, strip_h=64, block_w=256)
    torch.cuda.synchronize()
    assert torch.equal(out, cv.conv2d_plain(x, f))


def test_conv_launch_refuses_a_plan_outside_its_limits(card):
    """The C side checks the plan against its own limits and launches
    nothing for one it cannot run (cudaErrorInvalidValue)."""
    x = torch.zeros(64, 128, device=card)
    f = torch.ones(17, 17, device=card)
    out = torch.full((64, 128), 7.0, device=card)
    pl = cv.plan(32, 128, 17, 17)
    args = [pl.filter_width, pl.rows, pl.threads_x, pl.threads_y, pl.stages,
            pl.pitch, pl.shared_bytes]
    lib = cv._lib()
    stream = torch.cuda.current_stream().cuda_stream
    for i, bad in ((0, 5), (1, 4), (3, 512), (4, 4), (5, pl.pitch + 4),
                   (6, pl.shared_bytes + 4)):
        wrong = list(args)
        wrong[i] = bad
        assert lib.repro_conv2d(x.data_ptr(), f.data_ptr(), out.data_ptr(),
                                64, 128, 17, 17, 32, 128, *wrong,
                                stream) == 1
    torch.cuda.synchronize()
    assert bool((out == 7.0).all())
    assert lib.repro_conv2d(x.data_ptr(), f.data_ptr(), out.data_ptr(), 64,
                            128, 17, 17, 32, 128, *args, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, cv.conv2d_plain(x, f))


@pytest.mark.parametrize("h,w,sh,bw,tb", [
    (64, 128, 32, 128, 1), (64, 128, 32, 128, 2), (64, 128, 32, 128, 4),
    (256, 512, 64, 128, 16),
    # one case per plan class (tests/test_torch_hub_kernels.py, HOT_PLANS)
    (128, 512, 64, 512, 4),           # the hub tiling: 6 sub-tiles, last moved
    (128, 512, 64, 512, 16),          # 2 x 6 sub-tiles, t_block 16
    (64, 256, 8, 128, 3),             # one run of 16 rows a thread
    (64, 128, 32, 128, 16),           # the hub's deepest pyramid
    (512, 2048, 256, 1024, 8),        # 52 sub-tiles a tile
    (80, 96, 40, 32, 3),              # non-square grid, narrow tiles
    (40, 36, 8, 12, 16),              # halo wider than the tile
    (48, 160, 48, 160, 20),           # two launches (16 + 4)
])
def test_hotspot_kernel_matches_plain(card, h, w, sh, bw, tb):
    rng = np.random.default_rng(3)
    t, p = _randn(rng, (h, w), card), _randn(rng, (h, w), card, 0.1)
    before = hs.launches
    out = hs.hotspot(t, p, strip_h=sh, block_w=bw, t_block=tb)
    torch.cuda.synchronize()
    assert hs.launches == before + len(hs._launch_steps(tb))
    assert torch.equal(out, hs.hotspot_plain(t, p, t_block=tb))


def test_hotspot_launch_refuses_a_plan_outside_its_limits(card):
    """The C side checks the plan against its own limits and launches
    nothing for one it cannot run (cudaErrorInvalidValue)."""
    rng = np.random.default_rng(4)
    t, p = _randn(rng, (64, 128), card), _randn(rng, (64, 128), card, 0.1)
    out = torch.full((64, 128), 7.0, device=card)
    pl = hs.plan(32, 128, 4)
    args = [pl.t_block, pl.rows, pl.threads_x, pl.threads_y, pl.sub_h,
            pl.sub_w, pl.pitch, pl.shared_bytes]
    lib = hs._lib()
    stream = torch.cuda.current_stream().cuda_stream
    for i, bad in ((0, hs.MAX_STEPS + 1), (1, 8), (2, pl.threads_x + 1),
                   (3, hs.MAX_THREADS), (4, pl.sub_h + 32),
                   (5, pl.threads_x), (6, pl.pitch + 1),
                   (7, pl.shared_bytes + 4)):
        wrong = list(args)
        wrong[i] = bad
        assert lib.repro_hotspot(t.data_ptr(), p.data_ptr(), out.data_ptr(),
                                 64, 128, 32, 128, *wrong, stream) == 1
    assert lib.repro_hotspot(t.data_ptr(), p.data_ptr(), out.data_ptr(), 64,
                             128, 48, 128, *args, stream) == 1
    torch.cuda.synchronize()
    assert bool((out == 7.0).all())
    assert lib.repro_hotspot(t.data_ptr(), p.data_ptr(), out.data_ptr(), 64,
                             128, 32, 128, *args, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, hs.hotspot_plain(t, p, t_block=4))


@pytest.mark.parametrize("nchan,nt,ndm,bdm,bt", [
    (32, 768, 24, 8, 256), (32, 768, 24, 4, 192), (32, 768, 24, 16, 128),
    (48, 1000, 40, 12, 384),          # non-dividing dm and time tiles
    # every (G, T) class of the plan: G 1, 2, 4, 8 at T 4 and at T 2
    (32, 768, 24, 1, 128), (32, 768, 24, 2, 128), (32, 768, 24, 4, 128),
    (32, 768, 24, 8, 128), (32, 768, 24, 1, 192), (32, 768, 24, 2, 192),
    (32, 768, 24, 8, 192),
    (256, 2048, 64, 1, 128),          # the hub's channels, smallest tile
    (256, 8000, 256, 128, 3968),      # ... largest tile: 4 dm groups
    (37, 768, 24, 8, 256),            # channels not a multiple of a stage's
    (32, 1001, 24, 8, 256),           # ntime % 4 != 0: 4-byte copies
    (32, 700, 24, 32, 512),           # the last stages read past the signal
])
def test_dedisp_kernel_matches_plain(card, nchan, nt, ndm, bdm, bt):
    rng = np.random.default_rng(5)
    x = _randn(rng, (nchan, nt + dd.MAX_DELAY), card)
    delays = dd.make_delays(nchan, ndm, device=card)
    before = dd.launches
    out = dd.dedisperse(x, delays, block_dm=bdm, block_t=bt)
    torch.cuda.synchronize()
    assert dd.launches == before + 1
    assert out.shape == (ndm, nt)
    assert torch.equal(out, dd.dedisperse_plain(x, delays))


@pytest.mark.parametrize("nchan,nt,ndm,bdm,bt", [
    (32, 768, 24, 8, 256), (40, 1001, 33, 12, 384), (256, 2048, 64, 1, 128),
    (64, 4000, 130, 128, 3968), (256, 1024, 64, 32, 512),
    (32, 768, 24, 2, 192),
])
def test_dedisp_kernel_adversarial_delays(card, nchan, nt, ndm, bdm, bt):
    """A delay table that is not monotonic in dm, with values below 0 and
    above MAX_DELAY (clamped): channel spans reach MAX_DELAY, so a stage
    holds fewer channels than the plan's ``chans``."""
    rng = np.random.default_rng(7)
    x = _randn(rng, (nchan, nt + dd.MAX_DELAY), card)
    delays = torch.from_numpy(rng.integers(-100, 700, (nchan, ndm))
                              .astype(np.int32)).to(card)
    out = dd.dedisperse(x, delays, block_dm=bdm, block_t=bt)
    torch.cuda.synchronize()
    assert torch.equal(out, dd.dedisperse_plain(x, delays))


def test_dedisp_launch_refuses_a_plan_outside_its_limits(card):
    """The C side checks the plan against its own limits and launches
    nothing for one it cannot run (cudaErrorInvalidValue)."""
    x = torch.zeros(8, 1024, device=card)
    delays = torch.zeros(8, 4, dtype=torch.int32, device=card)
    out = torch.empty(4, 512, device=card)
    pl = dd.plan(4, 128, 8, 4)
    args = [pl.dms_per_thread, pl.samples_per_thread, pl.warps_dm,
            pl.warps_t, pl.chans, pl.stage_floats, pl.shared_bytes]
    lib = dd._lib()
    stream = torch.cuda.current_stream().cuda_stream
    for i, bad in ((4, dd.MAX_CHANS + 1), (6, pl.shared_bytes + 4),
                   (0, 3)):
        wrong = list(args)
        wrong[i] = bad
        assert lib.repro_dedisperse(x.data_ptr(), delays.data_ptr(),
                                    out.data_ptr(), 8, 1024, 4, 4, 128,
                                    *wrong, stream) == 1
    assert lib.repro_dedisperse(x.data_ptr(), delays.data_ptr(),
                                out.data_ptr(), 8, 1024, 4, 4, 128, *args,
                                stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, dd.dedisperse_plain(x, delays))


def test_hub_kernels_reject_before_launch_on_card(card):
    x = torch.zeros(64, 64, device=card)
    before = cv.launches
    with pytest.raises(cv.ConfigRejected):
        cv.conv2d(x, torch.zeros(35, 3, device=card), strip_h=8, block_w=96)
    assert cv.launches == before
    before = hs.launches
    with pytest.raises(hs.ConfigRejected):
        hs.hotspot(x, x, strip_h=48, block_w=64, t_block=1)
    assert hs.launches == before


@pytest.mark.parametrize("group,tiling", [(2, (128, 128)), (3, (64, 256)),
                                          (9, (256, 128))])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(card, dtype, causal, window,
                                              group, tiling):
    """tests/test_kernels.py's shapes with GQA groups 2, 3 and 9
    (starcoder2-7b's), window 64 under block_kv 128 and 256."""
    rng = np.random.default_rng(6)
    q = _randn(rng, (2 * group, 256, 64), card).to(dtype)
    k, v = (_randn(rng, (2, 256, 64), card).to(dtype) for _ in range(2))
    before = fa.launches
    out = fa.flash_attention(q, k, v, block_q=tiling[0], block_kv=tiling[1],
                             causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    torch.testing.assert_close(
        out.float(), fa.attention_plain(q, k, v, causal=causal,
                                        window=window).float(),
        rtol=RTOL[dtype], atol=RTOL[dtype])


# (q heads, kv heads, tokens, d, (block_q, block_kv), causal, window, dtype)
FA_PLAN_CASES = [
    (4, 2, 512, 128, (128, 128), True, None, torch.float32),   # d 128
    (4, 2, 256, 66, (64, 128), True, None, torch.float32),     # 4-byte copies
    (4, 2, 256, 66, (128, 64), False, 100, torch.bfloat16),
    (2, 1, 2048, 128, (64, 2048), True, None, torch.float32),  # narrow block
    (2, 1, 2048, 128, (1024, 2048), True, None, torch.float32),  # 8 q subs
    (4, 2, 512, 64, (128, 128), True, 100, torch.float32),     # window 100
    (4, 2, 512, 64, (256, 256), False, 100, torch.float32),
    (18, 2, 256, 64, (128, 128), True, None, torch.bfloat16),  # GQA 9 bf16
    (18, 2, 256, 128, (64, 256), True, 64, torch.bfloat16),
    (2, 1, 192, 1, (96, 48), True, None, torch.float32),       # d 1, part subs
]


@pytest.mark.parametrize("bh,bh_kv,s,d,tiling,causal,window,dtype",
                         FA_PLAN_CASES)
def test_flash_attention_plan_classes_match_plain(card, bh, bh_kv, s, d,
                                                  tiling, causal, window,
                                                  dtype):
    """Both block shapes and both staged widths of ``plan``: d 128 and d
    66 (not a multiple of 4), q tiles of 64 and 1024 rows and kv tiles of
    2048 on a 2048-token sequence, a window of 100 that crosses sub-tile
    edges, GQA 9 in bf16, and d 1 with kv tiles of 48 (a part sub-tile)
    and q tiles of 96 (fewer rows than a sub-tile)."""
    rng = np.random.default_rng(8)
    q = _randn(rng, (bh, s, d), card).to(dtype)
    k, v = (_randn(rng, (bh_kv, s, d), card).to(dtype) for _ in range(2))
    before = fa.launches
    out = fa.flash_attention(q, k, v, block_q=tiling[0], block_kv=tiling[1],
                             causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    torch.testing.assert_close(
        out.float(), fa.attention_plain(q, k, v, causal=causal,
                                        window=window).float(),
        rtol=RTOL[dtype], atol=RTOL[dtype])


def test_flash_attention_launch_refuses_a_plan_outside_its_limits(
        card, monkeypatch):
    """The C side launches only the instantiations it was built for, and
    nothing for a problem or plan outside its limits
    (cudaErrorInvalidValue); the wrapper raises for such a plan without
    counting a launch."""
    rng = np.random.default_rng(4)
    q = _randn(rng, (4, 256, 64), card)
    k, v = (_randn(rng, (2, 256, 64), card) for _ in range(2))
    out = torch.full((4, 256, 64), 7.0, device=card)
    pl = fa.plan(128, 128, 256, 64)
    args = [int(pl.bf16), pl.d_max, pl.threads, pl.sub_kv]
    lib = fa._lib()
    stream = torch.cuda.current_stream().cuda_stream

    def call(d, block_q, plan_args, skv=256, kv_len=256, causal=1):
        return lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
            4, 256, skv, kv_len, d, 2, block_q, 128, causal, -1, 0.125,
            *plan_args, stream)

    for i, bad in ((0, 2), (1, 96), (2, 512), (2, 128), (3, 32), (3, 16)):
        wrong = list(args)
        wrong[i] = bad
        assert call(64, 128, wrong) == 1
    assert call(65, 128, args) == 1          # d above the staged width
    assert call(64, 96, args) == 1           # a q tile not dividing s
    assert call(64, 128, args, kv_len=0) == 1    # a bound outside 1..skv
    assert call(64, 128, args, kv_len=257) == 1
    assert call(64, 128, args, skv=128, kv_len=100) == 1  # causal across
    assert call(64, 128, args, skv=200, kv_len=100, causal=0) == 1  # tile
    torch.cuda.synchronize()
    assert bool((out == 7.0).all())
    before = fa.launches
    monkeypatch.setattr(fa, "plan", lambda *_: dataclasses.replace(
        pl, threads=512))
    with pytest.raises(RuntimeError, match="cudaError 1"):
        fa.flash_attention(q, k, v)
    monkeypatch.undo()
    assert fa.launches == before
    assert call(64, 128, args) == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(out, fa.attention_plain(q, k, v),
                               rtol=RTOL[torch.float32],
                               atol=RTOL[torch.float32])


@pytest.mark.parametrize("bh,l,p,n,chunk", [
    (3, 256, 16, 8, 32), (3, 256, 16, 8, 64), (3, 256, 16, 8, 128),
    (2, 1024, 80, 128, 512),          # two 64-column slices, the largest chunk
    (2, 384, 64, 33, 96),             # a chunk that is not a multiple of 64
])
def test_ssd_kernel_matches_plain(card, bh, l, p, n, chunk):
    rng = np.random.default_rng(7)
    softplus = torch.nn.functional.softplus
    x = _randn(rng, (bh, l, p), card)
    dt = softplus(_randn(rng, (bh, l), card)) * 0.1
    a = -softplus(_randn(rng, (bh,), card))
    b, c = _randn(rng, (bh, l, n), card), _randn(rng, (bh, l, n), card)
    before = ssd.launches
    out = ssd.ssd_scan(x, dt, a, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    torch.testing.assert_close(out, ssd.ssd_plain(x, dt, a, b, c,
                                                  chunk=chunk),
                               rtol=3e-3, atol=3e-3)


@pytest.mark.parametrize("chunk", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("p", [16, 64, 80])
@pytest.mark.parametrize("n", [8, 64, 128, 200, 256])
def test_ssd_passes_match_plain(card, n, p, chunk):
    """The three kernels against ``ssd_plain`` over states up to 256 (200:
    a part k-slice), P of one, one full and a part 64-column slice, every
    chunk of the space, with one chunk and with three."""
    rng = np.random.default_rng(n * 1000 + p * 10 + chunk)
    softplus = torch.nn.functional.softplus
    for l in (chunk, 3 * chunk):
        x = _randn(rng, (2, l, p), card)
        dt = softplus(_randn(rng, (2, l), card)) * 0.1
        a = -softplus(_randn(rng, (2,), card))
        b, c = _randn(rng, (2, l, n), card), _randn(rng, (2, l, n), card)
        before = ssd.launches
        out = ssd.ssd_scan(x, dt, a, b, c, chunk=chunk)
        torch.cuda.synchronize()
        assert ssd.launches == before + 1
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out, ssd.ssd_plain(x, dt, a, b, c,
                                                      chunk=chunk),
                                   rtol=3e-3, atol=3e-3)


def test_ssd_passes_refuse_shapes_outside_their_limits(card):
    """Each pass's C entry returns cudaErrorInvalidValue, launching
    nothing, for a state above 256 or a chunk that does not divide L; the
    wrapper refuses N 257 before any launch."""
    lib = ssd._lib()
    stream = torch.cuda.current_stream().cuda_stream
    buf = torch.zeros(1 << 16, device=card)
    ptr = buf.data_ptr()
    for l, n, chunk in ((64, 257, 32), (64, 8, 48), (64, 8, 0)):
        shape = (2, l, 16, n, chunk)
        assert lib.repro_ssd_chunk_states(*[ptr] * 6, *shape, 1, stream) == 1
        assert lib.repro_ssd_state_pass(*[ptr] * 3, *shape, stream) == 1
        assert lib.repro_ssd_chunk_outputs(*[ptr] * 7, *shape, stream) == 1
    torch.cuda.synchronize()
    assert bool((buf == 0).all())
    before = ssd.launches
    z = torch.zeros(1, 64, 257, device=card)
    with pytest.raises(ssd.ConfigRejected):
        ssd.ssd_scan(torch.zeros(1, 64, 4, device=card),
                     torch.zeros(1, 64, device=card),
                     torch.zeros(1, device=card), z, z, chunk=32)
    assert ssd.launches == before


@pytest.mark.parametrize("chunk", [32, 128])
@pytest.mark.parametrize("n", [16, 64, 128, 256])
@pytest.mark.parametrize("chunks", [1, 3])
def test_ssd_final_state_matches_plain(card, n, chunk, chunks):
    """``final_state``: pass 1 also computes the last chunk's state and the
    state pass writes the state after it, within 3e-3 of ``ssd_plain``'s;
    y is bit-identical to a scan without it (pass 3 reads the same
    incoming states)."""
    rng = np.random.default_rng(n + chunk + chunks)
    softplus = torch.nn.functional.softplus
    l = chunk * chunks
    x = _randn(rng, (3, l, 64), card)
    dt = softplus(_randn(rng, (3, l), card)) * 0.1
    a = -softplus(_randn(rng, (3,), card))
    b, c = _randn(rng, (3, l, n), card), _randn(rng, (3, l, n), card)
    before = ssd.launches
    y, h = ssd.ssd_scan(x, dt, a, b, c, chunk=chunk, final_state=True)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    assert h.shape == (3, n, 64) and h.dtype == torch.float32
    y_ref, h_ref = ssd.ssd_plain(x, dt, a, b, c, chunk=chunk,
                                 final_state=True)
    torch.testing.assert_close(h, h_ref, rtol=3e-3, atol=3e-3)
    torch.testing.assert_close(y, y_ref, rtol=3e-3, atol=3e-3)
    assert torch.equal(y, ssd.ssd_scan(x, dt, a, b, c, chunk=chunk))


@pytest.mark.parametrize("shape", ["tiny", "zamba2"])
def test_model_call_sites_match_plain(card, shape):
    """The model's two kernel call sites on the card against their plain
    versions: ``blockwise_attention`` (bf16, padded to the tile) against
    ``attention_reference`` on the card, RTOL bf16; ``_ssd_chunked`` (y
    and the final state) against the same route on the CPU, which runs
    ``ssd_plain``, 3e-3. zamba2-1.2b's shapes: 32 heads of 64 over 1000
    tokens (padded to 1024), SSD 64 heads of 64, state 64, chunk 128."""
    from repro_torch.models import attention, mamba2
    rng = np.random.default_rng(11)
    b, s, h, d, nh, p, n, chunk = ((2, 50, 4, 16, 4, 32, 16, 16)
                                   if shape == "tiny" else
                                   (1, 1000, 32, 64, 64, 64, 64, 128))
    q, k, v = (_randn(rng, (b, s, h, d), card).to(torch.bfloat16)
               for _ in range(3))
    before = fa.launches
    out = attention.blockwise_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    torch.testing.assert_close(out.float(), attention.attention_reference(
        q, k, v).float(), rtol=RTOL[torch.bfloat16],
        atol=RTOL[torch.bfloat16])
    sp = s + (-s) % chunk
    softplus = torch.nn.functional.softplus
    x = _randn(rng, (b, sp, nh, p), card)
    dt = softplus(_randn(rng, (b, sp, nh), card)) * 0.1
    a = -softplus(_randn(rng, (nh,), card))
    bm, cm = _randn(rng, (b, sp, n), card), _randn(rng, (b, sp, n), card)
    before = ssd.launches
    y, hf = mamba2._ssd_chunked(x, dt, a, bm, cm, chunk)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    y_ref, h_ref = mamba2._ssd_chunked(*(t.cpu() for t in (x, dt, a, bm,
                                                            cm)), chunk)
    torch.testing.assert_close(y.cpu(), y_ref, rtol=3e-3, atol=3e-3)
    torch.testing.assert_close(hf.cpu(), h_ref, rtol=3e-3, atol=3e-3)


def _family_batch(cfg, toks):
    """``toks`` (B, S) with the entries of ``cfg``'s family, on the CPU:
    audio embeddings (normal), patch embeddings (normal x 0.02), M-RoPE
    positions 0..S-1."""
    rng = np.random.default_rng(4)
    b, s = toks.shape
    batch = {"tokens": toks}
    if cfg.family == "audio":
        batch["audio_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.n_audio_frames, cfg.d_model), dtype=np.float32))
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model), dtype=np.float32) * 0.02)
        batch["positions"] = torch.arange(s)[None, :, None].expand(b, s, 3)
    return batch


def _attention_launches(cfg) -> int:
    """Flash-attention launches of one forward: one an attention site
    (audio: the encoder's layers, then self- and cross-attention a decoder
    layer)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    if cfg.family == "audio":
        return cfg.n_encoder_layers + 2 * cfg.n_layers
    return 0 if cfg.family == "ssm" else cfg.n_layers


@pytest.mark.parametrize("name", ["gemma3-1b", "zamba2-1.2b",
                                  "qwen3-moe-235b-a22b", "whisper-small",
                                  "qwen2-vl-2b"])
@torch.no_grad()
def test_tiny_model_on_card_matches_cpu(card, name):
    """One tiny model's weights on both devices: prefill through the
    kernels on the card (one flash-attention launch an attention site,
    one SSD launch a Mamba layer) and a decode step, against the CPU's
    plain versions, within 0.05 (tests/test_models.py:74's tolerance).
    Serving only evaluates: no autograd graph (``torch.no_grad``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    cfg = get_config(name).tiny()
    model = tf.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    on_card = tf.init_params(cfg, torch.Generator().manual_seed(1),
                             device="cpu").to(card)
    on_card.load_state_dict(model.state_dict())
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 40)))
    batch = _family_batch(cfg, toks)
    mamba_layers = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    before = (fa.launches, ssd.launches)
    last, cache, n = tf.prefill(cfg, on_card, {
        k: v.to(card) for k, v in batch.items()}, 48)
    torch.cuda.synchronize()
    assert (fa.launches - before[0], ssd.launches - before[1]) == \
        (_attention_launches(cfg), mamba_layers)
    ref_last, ref_cache, _ = tf.prefill(cfg, model, batch, 48)
    assert (last.cpu() - ref_last).abs().max() < 0.05
    step, _ = tf.decode_step(cfg, on_card, cache, toks[:, :1].to(card), n)
    ref_step, _ = tf.decode_step(cfg, model, ref_cache, toks[:, :1], n)
    assert (step.cpu() - ref_step).abs().max() < 0.05


@pytest.mark.parametrize("group,tiling,causal,window", [
    (2, (128, 128), True, None), (3, (64, 256), True, 64),
    (1, (256, 128), False, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [129, 192, 256])
def test_flash_attention_wide_heads_match_plain(card, d, dtype, group,
                                                tiling, causal, window):
    """Head dims above 128 (gemma3-1b's 256): the d_max 256 instantiation,
    two blocks a q tile, each owning one half of the output's columns."""
    rng = np.random.default_rng(d)
    q = _randn(rng, (2 * group, 512, d), card).to(dtype)
    k, v = (_randn(rng, (2, 512, d), card).to(dtype) for _ in range(2))
    pl = fa.plan(*tiling, 512, d, dtype)
    assert (pl.d_max, pl.threads, pl.col_blocks) == (256, 128, 2)
    before = fa.launches
    out = fa.flash_attention(q, k, v, block_q=tiling[0], block_kv=tiling[1],
                             causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    torch.testing.assert_close(
        out.float(), fa.attention_plain(q, k, v, causal=causal,
                                        window=window).float(),
        rtol=RTOL[dtype], atol=RTOL[dtype])


# (q heads, kv heads, queries, keys, kv_len, d, (block_q, block_kv))
FA_CROSS_CASES = [
    (48, 48, 256, 1536, 1500, 64, (128, 128)),   # whisper's cross-attention
    (48, 48, 1536, 1536, 1500, 64, (128, 128)),  # its encoder
    (8, 4, 128, 384, 300, 128, (64, 128)),       # GQA 2, narrow block
    (12, 4, 256, 128, 77, 128, (128, 64)),       # GQA 3, fewer keys
    (8, 2, 64, 512, 512, 64, (64, 256)),         # GQA 4, no pad
    (4, 4, 192, 96, 1, 64, (64, 32)),            # one real key
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,bh_kv,sq,skv,kv_len,d,tiling", FA_CROSS_CASES)
def test_flash_attention_across_lengths_matches_plain(card, bh, bh_kv, sq,
                                                      skv, kv_len, d,
                                                      tiling, dtype):
    """Sq != Skv without a mask and a key-length bound: the kernel
    against ``attention_plain(kv_len=...)``, out and lse, RTOL of the
    dtype (lse: float32's); GQA 1-4, d 64 and 128, both block shapes."""
    rng = np.random.default_rng(sq + skv + kv_len)
    q = _randn(rng, (bh, sq, d), card).to(dtype)
    k, v = (_randn(rng, (bh_kv, skv, d), card).to(dtype) for _ in range(2))
    kw = dict(block_q=tiling[0], block_kv=tiling[1], causal=False,
              kv_len=kv_len)
    before = fa.launches
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref, lse_ref = fa.attention_plain(q, k, v, causal=False, kv_len=kv_len,
                                      return_lse=True)
    torch.testing.assert_close(out.float(), ref.float(), rtol=RTOL[dtype],
                               atol=RTOL[dtype])
    torch.testing.assert_close(lse, lse_ref, rtol=RTOL[torch.float32],
                               atol=RTOL[torch.float32])
    assert torch.equal(out, fa.flash_attention(q, k, v, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 96)])
def test_flash_attention_bound_at_the_length_changes_nothing(card, causal,
                                                            window, dtype):
    """On the shapes callers passed before the bound (Sq = Skv), an
    explicit ``kv_len`` = Skv gives out and lse bit-identical to none, at
    every staged width and both block shapes; and a causal call with its
    pad keys bounded (the model's padded prefill) bit-identical on the
    real rows."""
    rng = np.random.default_rng(21)
    for d in (64, 128, 256):
        for bq, bkv in ((64, 128), (128, 128), (256, 512)):
            q = _randn(rng, (4, 512, d), card).to(dtype)
            k, v = (_randn(rng, (2, 512, d), card).to(dtype)
                    for _ in range(2))
            kw = dict(block_q=bq, block_kv=bkv, causal=causal,
                      window=window, return_lse=True)
            out, lse = fa.flash_attention(q, k, v, **kw)
            out2, lse2 = fa.flash_attention(q, k, v, kv_len=512, **kw)
            assert torch.equal(out, out2) and torch.equal(lse, lse2)
    if causal:
        q = _randn(rng, (4, 128, 64), card).to(dtype)
        k, v = (_randn(rng, (2, 128, 64), card).to(dtype) for _ in range(2))
        full = fa.flash_attention(q, k, v, block_q=64, block_kv=64,
                                  window=window)
        bound = fa.flash_attention(q, k, v, block_q=64, block_kv=64,
                                   window=window, kv_len=70)
        assert torch.equal(full[:, :70], bound[:, :70])


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


def _scan_case(runs: int, n: int, seed: int = 0) -> tuple:
    """Budget-scan inputs over a 10,140-row table (a sixth of it misses)
    with non-fresh entries and a budget mix by run: no cap (inf and
    2**62), a time cap, a count cap, both, and a count already spent (a
    refusal at the first entry)."""
    rng = np.random.default_rng(seed)
    v = 10_140
    rows = rng.integers(0, v, (runs, n))
    fresh = rng.random((runs, n)) < 0.9
    col = np.where(rng.random(v) < 1 / 6, -1,
                   rng.permutation(v)).astype(np.int32)
    time_s = rng.random(v)
    charge_s = rng.random(v) * 10.0 ** rng.integers(-3, 2, v)
    spent0 = rng.random(runs)
    evals0 = rng.integers(0, 3, runs)
    kind = np.arange(runs) % 5
    total = float(charge_s.mean()) * n
    max_s = np.where((kind == 1) | (kind == 3),
                     spent0 + rng.random(runs) * total, np.inf)
    max_e = np.where((kind == 2) | (kind == 3),
                     evals0 + rng.integers(0, n + 1, runs), 2 ** 62)
    max_e = np.where(kind == 4, evals0, max_e).astype(np.int64)
    return (rows, fresh, col, time_s, charge_s, 0.37, spent0, evals0,
            max_s, max_e)


@pytest.mark.parametrize("n", [1, 8, 16, 31, 32, 33, 1000, 10_140])
@pytest.mark.parametrize("runs", [1, 3, 33, 1024])
def test_budget_scan_kernel_bit_identical_over_shapes(card, runs, n):
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(card)
                 if isinstance(a, np.ndarray) else a
                 for a in _scan_case(runs, n, seed=runs * 7 + n))
    before = engine_torch.replay.launches
    got = engine_torch.budget_scan(*args)
    assert engine_torch.replay.launches == before + 1
    want = engine_torch.budget_scan_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_packed_commit_rows_bit_identical_to_numpy_over_a_ga_run(card):
    cache = _cache()
    runners = [SimulationRunner(cache, Budget(max_evals=150), engine=engine,
                                device=card if engine == "torch" else None)
               for engine in ("torch", "numpy")]
    for runner in runners:
        get_strategy("genetic_algorithm", maxiter=4).run(
            cache.space, runner, random.Random(3))
    ours, ref = runners
    assert ours.torch_engine().dispatches > 1
    assert ours.trace == ref.trace
    assert (ours.budget.spent_seconds, ours.budget.spent_evals,
            ours.fresh_evals) == (ref.budget.spent_seconds,
                                  ref.budget.spent_evals, ref.fresh_evals)
    assert sorted(ours.memo) == sorted(ref.memo)


def test_packed_commit_rows_is_one_launch_a_call(card):
    cache = _cache()
    runner = SimulationRunner(cache, Budget(max_seconds=1e9),
                              engine="torch", device=card)
    engine = runner.torch_engine()
    rng = np.random.default_rng(4)
    for size in (1, 20, 32, 3, 100):
        rows = rng.permutation(cache.space.compiled.n_valid)[:size]
        before = engine_torch.replay.launches
        engine.commit_rows(rows)
        assert engine_torch.replay.launches == before + 1
    assert engine.blocks().host_in.is_pinned()
    assert engine.blocks().capacity == 128


def test_torch_engine_on_card_matches_numpy_engine(card):
    cache = _cache()
    for name in ("random_search", "genetic_algorithm", "simulated_annealing",
                 "pso", "dual_annealing", "differential_evolution",
                 "greedy_ils", "mls"):
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


def _fused_drivers(cache, device: str) -> list:
    """Random search (whole space and an eval cap), GA and PSO with caps
    that cut mid-generation, each on its own runner on ``device``."""
    total = sum(r.charge_s for r in cache.results.values())
    cases = [("random_search", {}, {"max_seconds": 1e9}),
             ("random_search", {}, {"max_evals": 37}),
             ("genetic_algorithm", {"popsize": 20},
              {"max_seconds": total * 0.4}),
             ("genetic_algorithm", {"popsize": 30}, {"max_evals": 137}),
             ("pso", {"popsize": 20}, {"max_seconds": total * 0.3}),
             ("pso", {"popsize": 30}, {"max_evals": 100})]
    return [SearchDriver(get_strategy(name, **hp), cache.space,
                         SimulationRunner(cache, Budget(**bk), engine="torch",
                                          device=device), random.Random(i))
            for i, (name, hp, bk) in enumerate(cases)]


def test_drive_fused_on_card_bit_identical_to_cpu(card):
    cache = _cache()
    got, want = _fused_drivers(cache, card), _fused_drivers(cache, "cpu")
    before = engine_torch.replay.launches
    engine_torch.drive_fused(got)
    assert engine_torch.replay.launches > before
    engine_torch.drive_fused(want)
    for a, b in zip(got, want):
        assert a.runner.trace == b.runner.trace
        assert (a.runner.budget.spent_seconds, a.runner.budget.spent_evals,
                a.runner.fresh_evals, a.exhausted) == \
            (b.runner.budget.spent_seconds, b.runner.budget.spent_evals,
             b.runner.fresh_evals, b.exhausted)
        assert sorted(a.runner.memo) == sorted(b.runner.memo)


@pytest.mark.parametrize("runs", [4, 32])
def test_fused_segment_is_one_launch(card, runs):
    """Random search asks its whole space at once: with no cap each run is
    one segment, so the group is one launch at R = ``runs`` (padded as the
    reference pads, to at least 8)."""
    cache = _cache()
    drivers = [SearchDriver(get_strategy("random_search"), cache.space,
                            SimulationRunner(cache, Budget(max_seconds=1e9),
                                             engine="torch", device=card),
                            random.Random(i)) for i in range(runs)]
    runs_ = [campaign.FusedRun(d) for d in drivers]
    before = engine_torch.replay.launches
    made = campaign._drive_group(runs_, cache.columns, cache.space.compiled)
    assert made == 1
    assert engine_torch.replay.launches == before + 1
    assert all(r.fresh_evals == cache.space.compiled.n_valid for r in runs_)
    blocks = campaign.scan_blocks(card)
    assert blocks.host_in.is_pinned()
    assert (max(runs, 8), engine_torch.replay._pad_len(
        cache.space.compiled.n_valid)) in blocks._calls


def _state(d) -> tuple:
    r = d.runner
    return (r.trace, sorted(r.memo), r.budget.spent_seconds,
            r.budget.spent_evals, r.fresh_evals, d.exhausted)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", ["dual_annealing", "basin_hopping"])
def test_host_driven_strategy_on_card_matches_numpy_engine(card, name,
                                                           seed):
    """Dual annealing (the scipy loop on the bridge thread, each
    evaluation on this thread) and basin hopping (a generator) on the
    torch engine on the card, stepped under the methodology's budget up to
    a cap (basin hopping can revisit forever, ROADMAP Queue 3): the numpy
    engine's state, with budget-scan launches on the card."""
    cache = _cache()
    budget = make_scorer(cache, engine="vectorized").budget_s

    def drive(engine, device):
        d = SearchDriver(get_strategy(name), cache.space,
                         SimulationRunner(cache, Budget(max_seconds=budget),
                                          engine=engine, device=device),
                         random.Random(seed))
        for _ in range(3000):
            if not d.step():
                break
        d.state.close()
        return d

    before = engine_torch.replay.launches
    got = drive("torch", card)
    assert engine_torch.replay.launches > before
    assert _state(got) == _state(drive("numpy", None))


def test_dual_annealing_direct_dispatch_on_card(card):
    """``Strategy.run`` dispatches dual annealing's ``_optimize`` directly:
    its ``runner(cfg)`` calls commit through the budget scan on the card,
    as the numpy engine commits them, and as the bridge does."""
    cache = _cache()
    budget = make_scorer(cache, engine="vectorized").budget_s
    runners = {}
    before = engine_torch.replay.launches
    for engine, device in (("torch", card), ("numpy", None)):
        runners[engine] = SimulationRunner(cache, Budget(max_seconds=budget),
                                           engine=engine, device=device)
        get_strategy("dual_annealing").run(cache.space, runners[engine],
                                           random.Random(2))
        if engine == "torch":
            assert engine_torch.replay.launches > before
    bridged = SearchDriver(get_strategy("dual_annealing"), cache.space,
                           SimulationRunner(cache, Budget(max_seconds=budget),
                                            engine="torch", device=card),
                           random.Random(2))
    bridged.run()
    for r in (runners["torch"], bridged.runner):
        assert r.trace == runners["numpy"].trace
        assert (r.budget.spent_seconds, r.fresh_evals) == \
            (runners["numpy"].budget.spent_seconds,
             runners["numpy"].fresh_evals)


def test_de_fused_on_card_matches_numpy_drive_many(card):
    """Differential evolution device-fused on the card (both updating
    modes, caps by time and by count): the numpy ``drive_many``'s state,
    in budget-scan launches at R = the group's runs."""
    cache = _cache()
    total = sum(r.charge_s for r in cache.results.values())
    cases = [({}, {"max_seconds": total * 0.3}),
             ({"updating": "deferred", "popsize": 10}, {"max_evals": 77}),
             ({"popsize": 30, "F": 1.2}, {"max_seconds": total * 0.2,
                                          "max_evals": 150})]

    def drivers(engine, device):
        return [SearchDriver(get_strategy("differential_evolution", **hp),
                             cache.space,
                             SimulationRunner(cache, Budget(**bk),
                                              engine=engine, device=device),
                             random.Random(i))
                for i, (hp, bk) in enumerate(cases)]

    got, want = drivers("torch", card), drivers("numpy", None)
    before = engine_torch.replay.launches
    drive_many(got, fuse="device")
    assert engine_torch.replay.launches > before
    drive_many(want)
    assert all(d.fuse == "device" for d in got)
    for a, b in zip(got, want):
        assert _state(a) == _state(b)


# ---------------------------------------------------------------- training
@pytest.mark.parametrize("group,tiling,causal,window", [
    (2, (128, 128), True, None), (1, (64, 128), True, 64),
    (4, (128, 256), False, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_attention_lse_matches_plain(card, d, dtype, group, tiling,
                                           causal, window):
    """The kernel's lse output against ``attention_plain``'s logsumexp
    (RTOL of float32: the lse is float32 whatever the operands), and its
    output bit-identical with and without the lse."""
    rng = np.random.default_rng(d + group)
    s = 256
    q = _randn(rng, (4, s, d), card).to(dtype)
    k, v = (_randn(rng, (4 // group, s, d), card).to(dtype)
            for _ in range(2))
    kw = dict(block_q=tiling[0], block_kv=tiling[1], causal=causal,
              window=window)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    _, lse_ref = fa.attention_plain(q, k, v, causal=causal, window=window,
                                    return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (4, s)
    torch.testing.assert_close(lse, lse_ref, rtol=RTOL[torch.float32],
                               atol=RTOL[torch.float32])
    assert torch.equal(out, fa.flash_attention(q, k, v, **kw))


@pytest.mark.parametrize("chunk", [16, 64, 128])
def test_ssd_chunk_states_match_plain(card, chunk):
    """The chunks' incoming states (the state scratch after the state
    pass) against ``ssd_plain``'s, 3e-3; y bit-identical with and without
    them, with the final state too."""
    x, dt, a, b, c = ssd.live_inputs({"bh": 6, "seq": 512, "p": 64,
                                      "n": 64, "seed": chunk}, card)
    y, states = ssd.ssd_scan(x, dt, a, b, c, chunk=chunk, chunk_states=True)
    y_ref, states_ref = ssd.ssd_plain(x, dt, a, b, c, chunk=chunk,
                                      chunk_states=True)
    assert states.shape == (6, 512 // chunk, 64, 64)
    torch.testing.assert_close(states, states_ref, rtol=3e-3, atol=3e-3)
    assert torch.equal(y, ssd.ssd_scan(x, dt, a, b, c, chunk=chunk))
    y2, h, states2 = ssd.ssd_scan(x, dt, a, b, c, chunk=chunk,
                                  final_state=True, chunk_states=True)
    assert torch.equal(y2, y) and torch.equal(states2, states)


def _grads(out, inputs, seed):
    cot = torch.randn(out.shape, generator=torch.Generator(
        device=out.device).manual_seed(seed), device=out.device)
    return torch.autograd.grad(out, inputs, cot.to(out.dtype))


@pytest.mark.parametrize("s,h,hkv,window,dtype", [
    (200, 4, 2, None, torch.float32), (256, 4, 1, 32, torch.float32),
    (1000, 32, 32, None, torch.bfloat16)])
def test_flash_function_grads_match_plain(card, s, h, hkv, window, dtype):
    """``blockwise_attention`` under autograd (the kernel's forward, the
    port's PyTorch backward) against autograd through
    ``attention_reference`` on the card: output and dq, dk, dv within
    RTOL of the operands' dtype (relative Frobenius error), and a flash
    attention launch for the forward."""
    from repro_torch.models import attention
    rng = np.random.default_rng(s)
    q = _randn(rng, (2, s, h, 64), card).to(dtype).requires_grad_()
    k, v = (_randn(rng, (2, s, hkv, 64), card).to(dtype).requires_grad_()
            for _ in range(2))
    before = fa.launches
    out = attention.blockwise_attention(q, k, v, window=window)
    assert fa.launches == before + 1
    ref = attention.attention_reference(q, k, v, window=window)
    tol = RTOL[dtype]
    for ours, want in zip((out, *_grads(out, (q, k, v), 1)),
                          (ref, *_grads(ref, (q, k, v), 1))):
        assert ((ours.float() - want.float()).norm()
                / want.float().norm()) < tol


@pytest.mark.parametrize("bsz,s,nh,p,n,chunk", [
    (2, 48, 4, 32, 16, 16), (1, 1024, 64, 64, 64, 128)])
def test_ssd_function_grads_match_plain(card, bsz, s, nh, p, n, chunk):
    """``_ssd_chunked`` under autograd (the kernels' forward with the
    chunks' states, the port's PyTorch backward) against autograd through
    ``ssd_plain`` on the card: dx, ddt, da, dB, dC within 3e-3 (relative
    Frobenius error); one SSD launch."""
    from repro_torch.models import mamba2
    rng = np.random.default_rng(s)
    softplus = torch.nn.functional.softplus
    x = _randn(rng, (bsz, s, nh, p), card).requires_grad_()
    dt = (softplus(_randn(rng, (bsz, s, nh), card)) * 0.1).requires_grad_()
    a = (-softplus(_randn(rng, (nh,), card))).requires_grad_()
    bm, cm = (_randn(rng, (bsz, s, n), card).requires_grad_()
              for _ in range(2))
    inputs = (x, dt, a, bm, cm)
    before = ssd.launches
    y, _ = mamba2._ssd_chunked(*inputs, chunk, final_state=False)
    assert ssd.launches == before + 1

    def per_head(t):
        return t[:, None].expand(bsz, nh, s, n).reshape(bsz * nh, s, n)

    ref = ssd.ssd_plain(x.permute(0, 2, 1, 3).reshape(bsz * nh, s, p),
                        dt.permute(0, 2, 1).reshape(bsz * nh, s),
                        a.repeat(bsz), per_head(bm), per_head(cm),
                        chunk=chunk)
    ref = ref.reshape(bsz, nh, s, p).permute(0, 2, 1, 3)
    for ours, want in zip((y, *_grads(y, inputs, 2)),
                          (ref, *_grads(ref, inputs, 2))):
        assert (ours - want).norm() / want.norm() < 3e-3


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("name", ["gemma3-1b", "zamba2-1.2b",
                                  "qwen3-moe-235b-a22b", "whisper-small",
                                  "qwen2-vl-2b"])
def test_tiny_train_step_on_card_matches_cpu(card, name, remat,
                                             monkeypatch):
    """One ``tiny()`` train step (remat full or dots, AdamW) on the card,
    through the kernels and their backward passes, against the same step
    on the CPU (the plain versions), in float32 compute (``COMPUTE_DTYPE``
    patched, as tests/test_torch_training.py does): the loss within 1e-4
    relative and every parameter within 3e-5, a tenth of the learning
    rate (AdamW's first step moves each parameter by about lr whatever
    its gradient's size, except where the gradient is within float32
    noise of zero)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train_step as ts
    monkeypatch.setattr(tf, "COMPUTE_DTYPE", torch.float32)
    cfg = get_config(name).tiny()
    opt = opt_mod.OptimizerConfig(peak_lr=3e-4, warmup_steps=1,
                                  total_steps=10)
    cpu = ts.init_train_state(cfg, opt, torch.Generator().manual_seed(0),
                              device="cpu")
    gpu = ts.init_train_state(cfg, opt, torch.Generator().manual_seed(1),
                              device="cpu")
    gpu["params"].load_state_dict(cpu["params"].state_dict())
    gpu["params"].to(card)
    gpu["opt"] = opt_mod.init_opt_state(
        opt, dict(gpu["params"].named_parameters()))
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 129))
    batch = _family_batch(cfg, torch.from_numpy(toks))
    step = ts.make_train_step(cfg, opt, ts.TrainConfig(remat=remat))
    before = (fa.launches, ssd.launches)
    _, m_gpu = step(gpu, batch)
    torch.cuda.synchronize()
    assert fa.launches > before[0]
    assert (ssd.launches > before[1]) == (cfg.family == "hybrid")
    _, m_cpu = step(cpu, batch)
    assert abs(float(m_gpu["loss"]) - float(m_cpu["loss"])) \
        < 1e-4 * abs(float(m_cpu["loss"]))
    for (name_, p), q in zip(gpu["params"].named_parameters(),
                             cpu["params"].parameters()):
        assert (p.detach().cpu() - q.detach()).abs().max() < 3e-5, name_


# ------------------------------------------------------------ free running
# ``engine_torch.free_run`` on the card: one budget-scan launch a
# generation, pinned seeds bit for bit, and the kernel's run bit-identical
# to the same run with the plain scan patched in (no tolerance)
FREE_NAMES = ("genetic_algorithm", "pso", "differential_evolution",
              "random_search")


def _free_kw(cache, runs=16, generations=12, share=0.2):
    total = float(cache.columns.charge_s.sum())
    return {"runs": runs, "seed": 3, "generations": generations,
            "max_seconds": total * share}


@pytest.mark.parametrize("name", FREE_NAMES)
def test_free_run_on_card_one_launch_a_generation(card, name):
    from repro_torch.core.engine_torch import replay as rp
    cache = _cache()
    kw = _free_kw(cache)
    before = rp.launches
    a = engine_torch.free_run(cache, name, device=card, **kw)
    assert rp.launches - before == kw["generations"]
    b = engine_torch.free_run(cache, name, device=card, **kw)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert a["curve_spent"].shape == (kw["runs"], kw["generations"])
    assert np.array_equal(a["spent_evals"], a["fresh_evals"])


@pytest.mark.parametrize("name", FREE_NAMES)
def test_free_run_on_card_matches_plain_scan(card, name):
    from unittest import mock

    from repro_torch.core.engine_torch import replay as rp
    from repro_torch.core.engine_torch import strategies as frs
    cache = _cache()
    kw = _free_kw(cache, share=0.1)
    out = frs.free_run(cache, name, device=card, **kw)
    with mock.patch.object(frs, "budget_scan", rp.budget_scan_plain):
        before = rp.launches
        plain = frs.free_run(cache, name, device=card, **kw)
        assert rp.launches == before
    for k in out:
        assert np.array_equal(out[k], plain[k]), k
    assert out["exhausted"].any()


@pytest.mark.parametrize("name", FREE_NAMES[:3])
def test_free_run_on_card_repairs_invalid_configs(card, name):
    """The hotspot space (5,040 valid of 6,144), half of it recorded: the
    repair path and the misses' mean charge on the card."""
    space = hs.space()
    rng = np.random.default_rng(9)
    results = {}
    for i, conf in enumerate(space.valid_configs):
        if rng.random() < 0.5:
            t = float(np.exp(rng.normal(-4.0, 1.0)))
            results[space.config_id(conf)] = CachedResult("ok", t, (t,), t)
    cache = CacheFile("hotspot", "synth", space, results)
    kw = _free_kw(cache, runs=32, generations=20, share=0.05)
    out = engine_torch.free_run(cache, name, device=card, **kw)
    compiled = cache.space.compiled
    finite = np.isfinite(out["best_value"])
    cols = cache.columns.rows_for_space(compiled)[out["best_row"][finite]]
    assert finite.any() and (cols >= 0).all()
    assert np.array_equal(cache.columns.time_s[cols],
                          out["best_value"][finite])
    assert (np.diff(out["curve_spent"], axis=1) >= 0).all()


def test_free_run_on_card_random_search_exhausts(card):
    cache = _cache()
    n = cache.space.compiled.n_valid
    out = engine_torch.free_run(cache, "random_search", device=card, runs=8,
                                seed=2, popsize=20,
                                generations=-(-n // 20) + 2)
    assert (out["fresh_evals"] == n).all()
    assert np.allclose(out["spent_seconds"],
                       float(cache.columns.charge_s.sum()), rtol=1e-10)
    assert (out["best_value"] == cache.optimum).all()


# The outputs reach the host through pinned blocks of the caching host
# allocator and one synchronisation of the stream
FREE_DTYPES = {"best_value": np.float64, "best_row": np.int32,
               "spent_seconds": np.float64, "spent_evals": np.int64,
               "fresh_evals": np.int64, "exhausted": np.bool_,
               "curve_spent": np.float64, "curve_best": np.float64}


def _count_syncs(fn) -> int:
    """Host synchronisations of one ``fn()``: the warnings of
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


@pytest.mark.parametrize("name", FREE_NAMES)
def test_free_run_on_card_outputs_outlive_later_calls(card, name):
    """A call's arrays share no memory with what a later call writes."""
    cache = _cache()
    kw = _free_kw(cache)
    kept = engine_torch.free_run(cache, name, device=card, **kw)
    copies = {k: np.copy(v) for k, v in kept.items()}
    later = [engine_torch.free_run(cache, name, device=card,
                                   **{**kw, "seed": seed})
             for seed in (4, 5)]
    assert any(not np.array_equal(later[0][k], copies[k]) for k in copies)
    for k in copies:
        assert np.array_equal(kept[k], copies[k]), k
        assert not any(np.shares_memory(kept[k], out[k]) for out in later), k


@pytest.mark.parametrize("name", FREE_NAMES)
def test_free_run_on_card_outputs_keep_their_form(card, name):
    cache = _cache()
    kw = _free_kw(cache)
    out = engine_torch.free_run(cache, name, device=card, **kw)
    R, G = kw["runs"], kw["generations"]
    assert list(out) == list(FREE_DTYPES)
    for k, dtype in FREE_DTYPES.items():
        a = out[k]
        assert isinstance(a, np.ndarray) and a.dtype == dtype, k
        assert a.shape == ((R, G) if k.startswith("curve") else (R,)), k
        assert a.flags.c_contiguous and a.flags.writeable, k


@pytest.mark.parametrize("name", FREE_NAMES)
def test_free_run_on_card_syncs_independent_of_generations(card, name):
    cache = _cache()
    kw = _free_kw(cache)
    engine_torch.free_run(cache, name, device=card, **kw)  # warm the tables
    syncs = {g: _count_syncs(lambda g=g: engine_torch.free_run(
        cache, name, device=card, **{**kw, "generations": g}))
        for g in (kw["generations"], 2 * kw["generations"])}
    assert len(set(syncs.values())) == 1 and min(syncs.values()) > 0, syncs


# ---------------------------------------------------- the hub on the card
def _calls(cache) -> int:
    """Kernel calls a live recording made: one warm-up and one a repeat
    for every ok config."""
    return sum(1 + len(r.times_s) for r in cache.results.values()
               if r.status == "ok")


def test_hub_framework_smokes_on_card(card, tmp_path):
    from repro_torch.cuda import device_label
    from repro_torch.hub import storage
    root = str(tmp_path / "hub")
    before = (fa.launches, ssd.launches)
    storage.build_hub(root, progress=None, device=card,
                      kernels=("flash_attention", "ssd"))
    label = device_label(card)
    assert sorted(storage.read_manifest(root)["files"]) == [
        f"flash_attention@{label}", f"ssd@{label}"]
    fa_cache = storage.load_cache(root, f"flash_attention@{label}")
    ssd_cache = storage.load_cache(root, f"ssd@{label}")
    assert fa.launches - before[0] == _calls(fa_cache) > 0
    assert ssd.launches - before[1] == _calls(ssd_cache) > 0


def test_live_fleet_and_warm_start_on_card(card, tmp_path):
    from repro_torch.cuda import device_label
    from repro_torch.hub import storage
    from repro_torch.scenarios import ScenarioMatrix, run_fleet
    from repro_torch.service import ConfigHub
    label = device_label(card)
    root = str(tmp_path / "hub")
    storage.write_manifest(root, storage.new_manifest())
    matrix = ScenarioMatrix(kernels=("hotspot",), devices=(label,),
                            shapes=("smoke",))
    before = hs.launches
    out = run_fleet(root, matrix=matrix, runner="live", max_evals=8,
                    device=card)
    assert len(out.recorded) == 1
    cache = storage.load_cache(root, f"hotspot@{label}#h=64,w=128")
    assert hs.launches - before == _calls(cache) > 0
    svc = ConfigHub(root, warm_start={"max_evals": 4, "device": card})
    before = dd.launches
    problem = dict(dd.SMOKE_PROBLEM)
    r = svc.lookup("dedispersion", problem, label)
    assert r.status == "warming"
    flight = svc.warm_start.ensure("dedispersion", label, r.problem)
    assert flight.join(120.0) and flight.error is None
    r = svc.lookup("dedispersion", problem, label)
    assert r.status == "exact"
    assert dd.launches - before == _calls(storage.load_cache(root, r.source))


# ------------------------------------------------------------ mesh tooling
# the kernels as operators, a one-rank DTensor mesh against the plain
# calls (bit-identical), and a fake-world dry-run cell on the card
def test_kernel_operators_launch_and_match_plain(card):
    """``torch.ops.repro_torch.*``: each call one launch, the outputs the
    direct launch's bit for bit and within the kernels' tolerances of the
    plain versions; the backward operators the functions they wrap."""
    from repro_torch.models import attention, mamba2
    gen = torch.Generator(device=card).manual_seed(3)
    q, k, v = (torch.randn((n, 256, 64), generator=gen, device=card)
               for n in (4, 2, 2))
    before = fa.launches
    out, lse = torch.ops.repro_torch.flash_attention(q, k, v, 64, 64, True,
                                                     -1, True, 256)
    assert fa.launches == before + 1
    direct, lse2 = fa.launch(q, k, v, block_q=64, block_kv=64,
                             return_lse=True)
    assert torch.equal(out, direct) and torch.equal(lse, lse2)
    torch.testing.assert_close(out, fa.attention_plain(q, k, v),
                               rtol=RTOL[torch.float32],
                               atol=RTOL[torch.float32])
    args = ssd.live_inputs({"bh": 4, "seq": 256, "p": 32, "n": 32},
                           device=card)
    before = ssd.launches
    y, h, states = torch.ops.repro_torch.ssd_scan(*args, 64, True, True)
    assert ssd.launches == before + 1
    y2, h2, states2 = ssd.launch(*args, chunk=64, final_state=True,
                                 chunk_states=True)
    assert torch.equal(y, y2) and torch.equal(h, h2) \
        and torch.equal(states, states2)
    yp = ssd.ssd_plain(*args, chunk=64)
    assert (y - yp).abs().max() < 3e-3 * max(1.0, yp.abs().max().item())
    dout = torch.randn(q.shape, generator=gen, device=card)
    got = torch.ops.repro_torch.flash_attention_bwd(q, k, v, out, lse, dout,
                                                    True, -1, 256)
    want = attention._flash_bwd(q, k, v, out, lse, dout, causal=True,
                                window=None, kv_len=256)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    dy = torch.randn(y.shape, generator=gen, device=card)
    got = torch.ops.repro_torch.ssd_scan_bwd(*args, states, dy, None, 64)
    want = mamba2._ssd_bwd(*args, states, dy, None, 64)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_one_rank_mesh_is_bit_identical_on_card(card, tmp_path):
    """Phase 12 (a) at a smaller depth: zamba2-1.2b at full width cut to
    7 layers (one group of 6 Mamba layers, the shared block, a tail of
    one) on a real one-rank ``nccl`` group: a prefill, two decode steps,
    the loss and every gradient with DTensor parameters equal the plain
    calls' bit for bit, with the same kernel launches."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.distribution import annotate as an
    from repro_torch.distribution import sharding as sh
    from repro_torch.launch.mesh import destroy_world, make_host_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.training.train_step import TrainConfig, make_loss_fn
    cfg = dataclasses.replace(get_config("zamba2-1.2b"), n_layers=7)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh()
        model = tf.init_params(cfg, torch.Generator(device=card).manual_seed(
            0), device=card)
        gen = torch.Generator(device=card).manual_seed(1)
        tokens = torch.randint(0, cfg.vocab, (2, 258), generator=gen,
                               device=card)
        loss_fn = make_loss_fn(cfg, TrainConfig(remat="full"))

        def run(place, whole):
            before = (fa.launches, ssd.launches)
            with torch.no_grad():
                last, cache, n = tf.prefill(
                    cfg, model, {"tokens": place(tokens[:, :256])}, 512)
                out = [whole(last)]
                for i in range(2):
                    step, cache = tf.decode_step(
                        cfg, model, cache, place(tokens[:, 256 + i:257 + i]),
                        n + i)
                    out.append(whole(step))
            loss = loss_fn(model, {"tokens": place(tokens[:, :129])})
            grads = torch.autograd.grad(loss, list(model.parameters()))
            return (out, whole(loss), [whole(g) for g in grads],
                    (fa.launches - before[0], ssd.launches - before[1]))

        plain = run(lambda t: t, lambda t: t)
        sh.distribute_model(model, mesh)

        def place(t):
            return sh.distribute_tree({"t": t}, mesh, sh.batch_shardings(
                mesh, {"t": t}))["t"]

        with an.annotation_mesh(mesh), implicit_replication():
            sharded = run(place, lambda t: t.full_tensor())
        assert all(torch.equal(a, b) for a, b in zip(plain[0], sharded[0]))
        assert torch.equal(plain[1], sharded[1])
        assert all(torch.equal(a, b) for a, b in zip(plain[2], sharded[2]))
        assert plain[3] == sharded[3] and all(plain[3])
    finally:
        destroy_world()


def test_fake_world_dry_run_cell_on_card(card):
    """olmo-1b train_4k at its published size on the 256-rank mesh of a
    fake world, fake tensors on the card: the record is ok and launches
    nothing."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import destroy_world, init_fake_world
    init_fake_world(512)
    try:
        before = (fa.launches, ssd.launches)
        rec = dryrun.run_cell("olmo-1b", "train_4k", "single", device=card)
        assert rec["status"] == "ok", rec.get("traceback")
        assert (fa.launches, ssd.launches) == before
        assert rec["cost"]["hlo_flops_per_chip"] > 0
        assert rec["memory"]["peak_bytes_per_chip"] > \
            rec["memory"]["argument_bytes_per_chip"] > 0
        assert sum(rec["collectives"]["counts"].values()) > 0
    finally:
        destroy_world()


# ------------------------------------------------ the hybrid_moe family
GRANITE_LIMIT_S = 300     # this test's own time limit


def _granite_mid(cfg):
    """granite-4.0-h-small-ep8 at a mid size on the card: its head, state,
    expert and shared widths, 4 layers (Mamba, attention, Mamba,
    attention), d 1024, 8 of 32 heads (2 kv), vocabulary 4,096, the
    router's 72 experts, top 10, 9 held."""
    return dataclasses.replace(
        cfg, name="granite-mid", n_layers=4,
        layer_types=("mamba", "attention", "mamba", "attention"),
        d_model=1024, n_heads=8, n_kv_heads=2, ssm_heads=32, vocab=4096)


def test_granite_mid_on_card_matches_reference(card):
    """The port's prefill through the kernels (flash attention at the 1/128
    scale of q·k, the SSD at chunk 256) and decode through the cache,
    against the benchmark's plain float32 reference on the card (TF32
    off), with the router skewed so that three experts take most tokens:
    the served bf16 logits within 5 % of the largest (2.2 % on the CPU's
    plain versions at this size: the logits come out of layer outputs
    that cancel), and in float32 compute, the conv cache too, within
    1e-3 of it (3.8e-6 on the CPU; the kernels reassociate float32 sums,
    flash attention's RTOL 2e-4); the attention layer
    alone in float32 within 1e-3 of the reference's at 1/128 (the kernel's
    float32 RTOL, 2e-4, over a 1,000-key softmax and two products) and
    not at d^-1/2; the held rows counted while traced equal the routed
    pairs (dropless). Runs under a time limit of its
    own (``GRANITE_LIMIT_S``)."""
    import importlib.util
    import pathlib
    import signal

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import hybrid_moe, mamba2
    from repro_torch.models import transformer as tf

    def too_long(*_):
        raise TimeoutError(f"over {GRANITE_LIMIT_S} s")

    old = signal.signal(signal.SIGALRM, too_long)
    signal.alarm(GRANITE_LIMIT_S)
    try:
        root = pathlib.Path(__file__).resolve().parents[1]
        spec = importlib.util.spec_from_file_location(
            "granite4h_ref", root / "portbench/reference/granite4h.py")
        ref = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ref)
        cfg = _granite_mid(get_config("granite-4.0-h-small-ep8"))
        rcfg = {**__import__("json").loads((
            root / "portbench/configs/granite-4.0-h-small-ep8.json"
        ).read_text()), "hidden_size": cfg.d_model, "num_attention_heads":
            cfg.n_heads, "num_key_value_heads": cfg.n_kv_heads,
            "mamba_n_heads": cfg.ssm_heads, "layer_types":
            list(cfg.layer_types)}
        b, s, new = 2, 1000, 4
        toks = torch.from_numpy(np.random.default_rng(38).integers(
            0, cfg.vocab, (b, s))).to(card)
        torch.backends.cuda.matmul.allow_tf32 = False
        with torch.no_grad():
            model = tf.init_params(cfg, torch.Generator(
                device=card).manual_seed(38), device=card)
            for blk in model.layers:     # uneven: experts 0-2 preferred
                blk.moe.router[:, :3] *= 6.0
            w = {n: p.detach() for n, p in model.named_parameters()}

            def served(dtype):
                tf.COMPUTE_DTYPE = tf.CACHE_DTYPE = dtype
                mamba2.CONV_DTYPE = (torch.float32 if dtype == torch.float32
                                     else torch.bfloat16)
                try:
                    launches = fa.launches
                    logits, cache, n = tf.prefill(cfg, model,
                                                  {"tokens": toks}, s + new)
                    torch.cuda.synchronize()
                    assert fa.launches - launches == 2
                    out, fed = [logits], []
                    cl = torch.full((b,), n, device=card)
                    for _ in range(new - 1):
                        fed.append(logits.argmax(-1))
                        logits, cache = tf.decode_step(
                            cfg, model, cache, fed[-1][:, None], cl)
                        cl = cl + 1
                        out.append(logits)
                    return torch.stack(out, 1), torch.stack(fed, 1)
                finally:
                    tf.COMPUTE_DTYPE = tf.CACHE_DTYPE = torch.bfloat16
                    mamba2.CONV_DTYPE = torch.bfloat16

            def reference(fed, **over):
                feed = torch.cat([toks, fed], 1)
                return torch.cat([ref.logits({**rcfg, **over}, w,
                                             feed[i:i + 1], s - 1)
                                  for i in range(b)])

            for dtype, tol in ((torch.bfloat16, 5e-2), (torch.float32, 1e-3)):
                ours, fed = served(dtype)
                want = reference(fed)
                err = (ours - want).abs().max() / want.abs().max()
                assert err <= tol, (dtype, float(err))
            # the attention layer alone, float32 through the kernel: at
            # the 1/128 scale, and far from the reference at d^-1/2
            tf.COMPUTE_DTYPE = torch.float32
            try:
                z = torch.randn((b, s, cfg.d_model), device=card,
                                generator=torch.Generator(
                                    device=card).manual_seed(39))
                got = model.layers[1].attn(z, None, rope=False)[0]
            finally:
                tf.COMPUTE_DTYPE = torch.bfloat16
            for mult, close in ((cfg.attention_multiplier, True),
                                (128 ** -0.5, False)):
                want = torch.stack([ref._attention(
                    {**rcfg, "attention_multiplier": mult}, w,
                    "layers.1.attn.", z[i]) for i in range(b)])
                err = (got - want).abs().max() / want.abs().max()
                assert bool(err <= 1e-3) == close, (mult, float(err))
            for name in ("calls", "decode_steps", "tokens_routed",
                         "held_rows"):
                setattr(hybrid_moe, name, 0)
            rows = []
            hooks = [blk.moe.register_forward_hook(
                lambda mod, args, out: rows.append(int(mod.route(
                    args[0].reshape(-1, cfg.d_model))[2].sum())))
                for blk in model.layers]
            with profile(activities=[ProfilerActivity.CPU]):
                served(torch.bfloat16)
            for h in hooks:
                h.remove()
            counted = hybrid_moe.counters()
            assert counted["held_rows"] == sum(rows)
            # uneven: far above the even 10 x 9 / 72 = 1.25 a token
            assert counted["held_rows"] / counted["tokens_routed"] > 2.0
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def test_granite_decode_graph_replays_the_eager_step(card):
    """The family's decode on the card: the first step eager, then the
    captured graph replayed, a second prefill's cache taken over; every
    step's logits equal to the eager step's through the same cache, bit
    for bit. While a profiler records and no graph fits, the step runs
    eagerly and captures nothing."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import hybrid_moe
    from repro_torch.models import transformer as tf

    cfg = _granite_mid(get_config("granite-4.0-h-small-ep8"))
    b, s, new = 2, 300, 4
    with torch.inference_mode():
        model = tf.init_params(cfg, torch.Generator(
            device=card).manual_seed(41), device=card)

        def steps(toks, graphed):
            logits, cache, n = tf.prefill(cfg, model, {"tokens": toks},
                                          s + new)
            cl, out = torch.full((b,), n, device=card), [logits]
            for _ in range(new - 1):
                nxt = logits.argmax(-1)[:, None]
                if graphed:
                    logits, cache = tf.decode_step(cfg, model, cache, nxt,
                                                   cl)
                else:
                    logits = hybrid_moe._step(cfg, model, cache, nxt, cl)
                cl = cl + 1
                out.append(logits)
            return torch.stack(out, 1)

        for seed in (1, 2):
            toks = torch.randint(0, cfg.vocab, (b, s), device=card,
                                 generator=torch.Generator(
                                     device=card).manual_seed(seed))
            assert torch.equal(steps(toks, True), steps(toks, False))
        graph = model.__dict__["_decode_graph"]
        assert isinstance(graph, hybrid_moe._DecodeGraph)
        del model.__dict__["_decode_graph"]
        with profile(activities=[ProfilerActivity.CPU]):
            traced = steps(toks, True)
        assert "_decode_graph" not in model.__dict__
        assert torch.equal(traced, steps(toks, False))

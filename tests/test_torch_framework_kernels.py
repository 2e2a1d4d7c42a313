"""The port's flash attention and SSD scan against the reference.

On the CPU each wrapper takes its kernel's plain PyTorch version. Both the
plain version and the CPU wrapper are held here against the reference's
Pallas kernel in interpret mode, on the same numpy-seeded arrays, with the
tolerances of tests/test_kernels.py: ``RTOL[dtype]`` (2e-4 float32, 2e-2
bf16) for attention, whose plain version sums in another order and, in
bf16, does not round p before the p v product as the kernel does; 3e-3 for
the SSD scan, whose chunked sums differ in order from the step-by-step
recurrence. The spaces, config ids and cost-model workloads must equal the
reference's exactly. The CUDA kernels themselves are compared with the
plain versions on the card by chip_smoke.py and tests/test_torch_cuda.py.
"""
import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cache import result_to_json as ref_result_to_json
from repro.core.costmodel import estimate as ref_estimate
from repro.core.devices import HUB_DEVICES as REF_DEVICES
from repro.core.record import merge_shards as ref_merge_shards
from repro.kernels import flash_attention as ref_fa
from repro.models import attention as ref_attn
from repro.kernels import ssd as ref_ssd
from repro_torch.core import record
from repro_torch.core.cache import result_to_json
from repro_torch.core.costmodel import estimate
from repro_torch.core.devices import DEVICES_BY_NAME
from repro_torch.kernels import get_kernel
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd

RTOL = {"float32": 2e-4, "bfloat16": 2e-2}
SSD_TOL = 3e-3
# full model widths: starcoder2-7b's attention on one 4096-token sequence,
# mamba2-130m's SSD over 8 sequences of 4096
FULL = {fa: {"bh": 36, "bh_kv": 4, "seq": 4096, "d": 128},
        ssd: {"bh": 24 * 8, "seq": 4096, "p": 64, "n": 128}}
PAIRS = [(fa, ref_fa, 50), (ssd, ref_ssd, 30)]
NAMES = {fa: "flash_attention", ssd: "ssd"}


def _randn(rng, shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _kw(fn, problem):
    """``problem`` cut to the keyword arguments ``fn`` declares."""
    return {k: v for k, v in problem.items()
            if k in inspect.signature(fn).parameters}


def _softplus(x):
    return np.log1p(np.exp(x)).astype(np.float32)


# ------------------------------------------------------- kernel arithmetic
@pytest.mark.parametrize("tiling", [(128, 128), (64, 256)])
@pytest.mark.parametrize("group", [2, 3])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas_interpret(dtype, causal, window,
                                                  group, tiling):
    """tests/test_kernels.py's sweep (4 q heads over 2 kv heads, 256
    tokens, d 64), also with a GQA group of 3, and window 64 under a
    block_kv of 128 or 256: rows whose first kv tiles are all masked."""
    rng = np.random.default_rng(6)
    q = _randn(rng, (2 * group, 256, 64))
    k, v = _randn(rng, (2, 256, 64)), _randn(rng, (2, 256, 64))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    bq, bkv = tiling
    ref = np.asarray(ref_fa.flash_attention(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)), block_q=bq,
        block_kv=bkv, causal=causal, window=window, interpret=True),
        np.float32)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    before = fa.launches
    for out in (fa.attention_plain(tq, tk, tv, causal=causal, window=window),
                fa.flash_attention(tq, tk, tv, block_q=bq, block_kv=bkv,
                                   causal=causal, window=window)):
        assert out.dtype == tdt and out.shape == q.shape
        np.testing.assert_allclose(out.float().numpy(), ref,
                                   rtol=RTOL[dtype], atol=RTOL[dtype])
    assert fa.launches == before


@pytest.mark.parametrize("group,tiling,causal,window", [
    (2, (128, 128), True, None), (3, (64, 128), True, 64),
    (1, (128, 64), False, None)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [192, 256])
def test_flash_attention_wide_heads_match_pallas_interpret(d, dtype, group,
                                                           tiling, causal,
                                                           window):
    """Head dims above 128, up to gemma3-1b's 256: the CPU path computes
    what the reference's Pallas kernel (interpret mode) and its
    ``attention_ref`` compute, causal, windowed and with GQA groups of 1
    to 3; the plan is the d_max 256 instantiation."""
    rng = np.random.default_rng(d)
    q = _randn(rng, (2 * group, 256, d))
    k, v = _randn(rng, (2, 256, d)), _randn(rng, (2, 256, d))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    bq, bkv = tiling
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    pallas = np.asarray(ref_fa.flash_attention(
        jq, jk, jv, block_q=bq, block_kv=bkv, causal=causal, window=window,
        interpret=True), np.float32)
    oracle = np.asarray(ref_fa.attention_ref(jq, jk, jv, causal=causal,
                                             window=window), np.float32)
    pl = fa.plan(bq, bkv, 256, d, tdt)
    assert (pl.d_max, pl.threads, pl.col_blocks) == (256, 128, 2)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    before = fa.launches
    out = fa.flash_attention(tq, tk, tv, block_q=bq, block_kv=bkv,
                             causal=causal, window=window)
    assert out.dtype == tdt and out.shape == q.shape
    for ref in (pallas, oracle):
        np.testing.assert_allclose(out.float().numpy(), ref,
                                   rtol=RTOL[dtype], atol=RTOL[dtype])
    assert fa.launches == before


def test_attention_plain_equals_reference_oracle():
    """The plain version is the reference's ``attention_ref``, operation for
    operation, up to float32 reassociation in the two products."""
    rng = np.random.default_rng(2)
    q, k, v = _randn(rng, (6, 128, 32)), _randn(rng, (2, 128, 32)), \
        _randn(rng, (2, 128, 32))
    for causal, window in ((True, None), (False, 16), (True, 1)):
        ref = np.asarray(ref_fa.attention_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            window=window))
        out = fa.attention_plain(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal, window=window)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("chunk", [32, 64, 128])
def test_ssd_matches_pallas_interpret_and_recurrence(chunk):
    """tests/test_kernels.py's sweep: (3, 256, 16, 8), dt and -a softplus of
    a normal."""
    rng = np.random.default_rng(7)
    bh, l, p, n = 3, 256, 16, 8
    x = _randn(rng, (bh, l, p))
    dt = _softplus(_randn(rng, (bh, l))) * np.float32(0.1)
    a = -_softplus(_randn(rng, (bh,)))
    b, c = _randn(rng, (bh, l, n)), _randn(rng, (bh, l, n))
    args = tuple(jnp.asarray(t) for t in (x, dt, a, b, c))
    pallas = np.asarray(ref_ssd.ssd_scan(*args, chunk=chunk, interpret=True))
    recurrence = np.asarray(ref_ssd.ssd_ref(*args))
    targs = tuple(torch.from_numpy(t) for t in (x, dt, a, b, c))
    before = ssd.launches
    for out in (ssd.ssd_plain(*targs, chunk=chunk),
                ssd.ssd_scan(*targs, chunk=chunk)):
        assert out.dtype == torch.float32 and out.shape == x.shape
        for ref in (pallas, recurrence):
            np.testing.assert_allclose(out.numpy(), ref, rtol=SSD_TOL,
                                       atol=SSD_TOL)
    assert ssd.launches == before


@pytest.mark.parametrize("chunk", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("p,n", [(16, 256), (80, 64)])
def test_ssd_wide_state_and_head_match_pallas_and_recurrence(p, n, chunk):
    """A state of 256 (the new limit) and a head dim of 80 (a full and a
    part 64-column slice on the card), at every chunk of the space up to
    the whole 512-step sequence: ``ssd_scan`` (its CPU path) and
    ``ssd_plain`` within 3e-3 of the Pallas kernel and of the
    step-by-step recurrence."""
    rng = np.random.default_rng(n + p)
    bh, l = 2, 512
    x = _randn(rng, (bh, l, p))
    dt = _softplus(_randn(rng, (bh, l))) * np.float32(0.1)
    a = -_softplus(_randn(rng, (bh,)))
    b, c = _randn(rng, (bh, l, n)), _randn(rng, (bh, l, n))
    args = tuple(jnp.asarray(t) for t in (x, dt, a, b, c))
    pallas = np.asarray(ref_ssd.ssd_scan(*args, chunk=chunk, interpret=True))
    recurrence = np.asarray(ref_ssd.ssd_ref(*args))
    targs = tuple(torch.from_numpy(t) for t in (x, dt, a, b, c))
    before = ssd.launches
    for out in (ssd.ssd_plain(*targs, chunk=chunk),
                ssd.ssd_scan(*targs, chunk=chunk)):
        assert out.dtype == torch.float32 and out.shape == x.shape
        for ref in (pallas, recurrence):
            np.testing.assert_allclose(out.numpy(), ref, rtol=SSD_TOL,
                                       atol=SSD_TOL)
    assert ssd.launches == before


def test_ssd_plain_survives_an_overflowing_upper_triangle():
    """Above the diagonal exp(cum_i - cum_j) overflows to inf for a steep
    decay; the mask selects 0 there, so no inf times 0 turns into NaN."""
    rng = np.random.default_rng(8)
    x, b, c = (_randn(rng, s) for s in ((2, 128, 8), (2, 128, 4),
                                        (2, 128, 4)))
    dt = np.full((2, 128), 2.0, np.float32)
    a = np.full((2,), -1.0, np.float32)
    args = tuple(torch.from_numpy(t) for t in (x, dt, a, b, c))
    out = ssd.ssd_plain(*args, chunk=128)
    assert torch.isfinite(out).all()
    ref = np.asarray(ref_ssd.ssd_ref(*(jnp.asarray(t)
                                       for t in (x, dt, a, b, c))))
    np.testing.assert_allclose(out.numpy(), ref, rtol=SSD_TOL, atol=SSD_TOL)


# -------------------------------------------------- spaces and cost model
@pytest.mark.parametrize("width", ["smoke", "full"])
@pytest.mark.parametrize("ours,ref,size", PAIRS)
def test_space_identical_to_reference(ours, ref, size, width):
    problem = ours.SMOKE_PROBLEM if width == "smoke" else FULL[ours]
    a, b = get_kernel(NAMES[ours]).space(problem), \
        ref.space(**_kw(ref.space, problem))
    if width == "full":
        assert a.size == b.size == size
    assert [(t.name, t.values) for t in a.tunables] == \
        [(t.name, t.values) for t in b.tunables]
    assert a.valid_configs == b.valid_configs
    assert [a.config_id(c) for c in a.valid_configs] == \
        [b.config_id(c) for c in b.valid_configs]
    assert ours.SMOKE_PROBLEM == ref.SMOKE_PROBLEM


@pytest.mark.parametrize("width", ["smoke", "full"])
@pytest.mark.parametrize("ours,ref,size", PAIRS)
def test_workload_matches_reference(ours, ref, size, width):
    problem = ours.SMOKE_PROBLEM if width == "smoke" else FULL[ours]
    spec = get_kernel(NAMES[ours])
    space = spec.space(problem)
    wl_ref = ref.workload(**_kw(ref.workload, problem))
    for conf in space.valid_configs:
        d = space.as_dict(conf)
        for dev in REF_DEVICES:
            x = estimate(spec.workload(problem), d, DEVICES_BY_NAME[dev.name],
                         "x")
            y = ref_estimate(wl_ref, d, dev, "x")
            assert (x.status, x.time_s, x.compile_s) == \
                (y.status, y.time_s, y.compile_s)


def test_full_width_workloads_give_the_bounds_operation_counts():
    """The bounds chip_smoke.py reports rest on these counts."""
    wl = fa.workload(bh=36, seq=4096, d=128)
    assert wl.flops({}) == 4.0 * 36 * 4096 ** 2 * 128 * 0.5   # 154.6 GFLOP
    assert round(ssd.needed_flops(**FULL[ssd]) / 1e9, 1) == 25.8
    assert ssd.needed_flops(**FULL[ssd]) == 4.0 * 192 * 4096 * 128 * 64
    # the cost model counts each chunk's whole Q x Q square on top
    wl = ssd.workload(**FULL[ssd])
    assert round(wl.flops({"chunk": 128}) / 1e9, 1) == 64.4
    assert round(wl.flops({"chunk": 512}) / 1e9) == 180
    assert all(wl.flops({"chunk": q}) > ssd.needed_flops(**FULL[ssd])
               for q in (32, 64, 128, 256, 512))


def test_chunked_flops_give_the_algorithm_floors():
    """The algorithm floor chip_smoke.py prints beside the operations
    bound: the state products plus the intra-chunk products over 64-step
    sub-tiles on or below the diagonal (54.8 GFLOP at chunk 128)."""
    full = FULL[ssd]
    assert {q: round(ssd.chunked_flops(**full, chunk=q) / 1e9, 1)
            for q in (32, 64, 128, 256, 512)} == \
        {32: 35.4, 64: 45.1, 128: 54.8, 256: 74.1, 512: 112.7}
    q = 128
    intra = 192 * (4096 // q) * 3 * 2 * 64 * 64 * (128 + 64)
    assert ssd.chunked_flops(**full, chunk=q) == \
        ssd.needed_flops(**full) + intra
    assert ssd.chunked_flops(bh=1, seq=96, p=8, n=8, chunk=96) == \
        ssd.needed_flops(bh=1, seq=96, p=8, n=8) + 3 * 2 * 64 * 64 * 16


# ---------------------------------------------------------------- fitting
@pytest.mark.parametrize("ours,ref,size", PAIRS)
def test_every_full_width_tiling_fits(ours, ref, size):
    """The kernels walk a tile too large for one block in sub-tiles, so
    no tiling of the full-width spaces is rejected."""
    space = get_kernel(NAMES[ours]).space(FULL[ours])
    assert space.size == size
    assert all(ours.fits(space.as_dict(c), FULL[ours])
               for c in space.valid_configs)


def test_fits_rejects_what_the_kernels_cannot_run():
    """Head dims and states up to 256 run; 257 is refused before any
    launch, on the CPU as on the card. A chunk has no length limit: its
    cum goes through device memory."""
    assert not fa.fits({"block_q": 64, "block_kv": 128}, {"d": 257})
    assert fa.fits({"block_q": 64, "block_kv": 128}, {"d": 256})
    assert fa.fits({"block_q": 1024, "block_kv": 128},
                   {"d": 129, "seq": 4096})
    assert not ssd.fits({"chunk": 128}, {"n": 257})
    assert ssd.fits({"chunk": 128}, {"n": 256})
    assert ssd.fits({"chunk": 12288}, {"n": 256})
    assert not ssd.fits({"chunk": 0}, {"n": 128})
    with pytest.raises(fa.ConfigRejected):
        fa.flash_attention(*(torch.zeros(2, 128, 257) for _ in range(3)),
                           block_q=64, block_kv=128)
    with pytest.raises(ssd.ConfigRejected):
        ssd.ssd_scan(torch.zeros(1, 64, 4), torch.zeros(1, 64),
                     torch.zeros(1), torch.zeros(1, 64, 257),
                     torch.zeros(1, 64, 257), chunk=32)
    assert issubclass(fa.ConfigRejected, ValueError)


def test_wrappers_keep_the_reference_asserts_and_check_inputs():
    q = torch.zeros(3, 128, 16)
    with pytest.raises(AssertionError):
        fa.flash_attention(q, torch.zeros(2, 128, 16), torch.zeros(2, 128, 16))
    with pytest.raises(AssertionError):
        fa.flash_attention(q, q, q, block_q=96, block_kv=128)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, q, q, block_q=64, block_kv=64, window=0)
    with pytest.raises(ValueError, match="positive"):
        fa.flash_attention(q, q, q, block_q=-64, block_kv=64)
    with pytest.raises(ValueError, match="float32 or bf16"):
        fa.flash_attention(q.double(), q.double(), q.double())
    x = torch.zeros(2, 96, 4)
    args = (x, torch.zeros(2, 96), torch.zeros(2), torch.zeros(2, 96, 3),
            torch.zeros(2, 96, 3))
    with pytest.raises(AssertionError):
        ssd.ssd_scan(*args, chunk=64)
    with pytest.raises(ValueError, match="float32"):
        ssd.ssd_scan(x.double(), *args[1:], chunk=32)
    with pytest.raises(ValueError, match="positive"):
        ssd.ssd_scan(*args, chunk=0)
    with pytest.raises(ValueError, match="BH, L"):
        ssd.ssd_scan(x, torch.zeros(2, 95), *args[2:], chunk=32)


# ------------------------------------------------- the kernel's launch plan
# plan(block_q, block_kv, 4096, 128) of every hub tiling: (threads, sub_q,
# sub_kv); 64-row q tiles take the narrow block
HUB_PLANS = {64: (128, 64, 32)}
WIDE_PLAN = (256, 128, 64)


def test_attention_plans_are_pinned():
    """The plan of each of the 50 hub tilings at d 128, of the smoke
    space's 12 at d 64, and of d 66 and d 1; none is refused."""
    space = get_kernel("flash_attention").space(FULL[fa])
    assert space.size == 50
    for conf in map(space.as_dict, space.valid_configs):
        pl = fa.plan(conf["block_q"], conf["block_kv"], 4096, 128)
        assert (pl.threads, pl.sub_q, pl.sub_kv) == \
            HUB_PLANS.get(conf["block_q"], WIDE_PLAN)
        assert (pl.bf16, pl.rows, pl.stages, pl.d_max, pl.pitch) == \
            (False, 4, 3, 128, 132)
        assert pl.q_sub_tiles(conf["block_q"]) == max(1,
                                                      conf["block_q"] // 128)
    smoke = get_kernel("flash_attention").space()
    assert smoke.size == 12
    for conf in map(smoke.as_dict, smoke.valid_configs):
        pl = fa.plan(conf["block_q"], conf["block_kv"], 256, 64)
        assert (pl.threads, pl.sub_kv, pl.d_max, pl.pitch) \
            == ((128, 32, 64, 68) if conf["block_q"] == 64
                else (256, 64, 64, 68))
    assert fa.plan(64, 64, 256, 66) == fa.Plan(False, 128, 128, 32)
    assert fa.plan(64, 64, 256, 66).sub_q == 64
    assert fa.plan(96, 48, 192, 1, torch.bfloat16) == fa.Plan(
        True, 64, 256, 64)
    assert fa.plan(128, 128, 512, 129) == fa.Plan(False, 256, 128, 32)
    assert fa.plan(1024, 128, 2048, 256, torch.bfloat16) == fa.Plan(
        True, 256, 128, 32)
    assert fa.plan(128, 128, 512, 256).col_blocks == 2
    assert fa.plan(128, 128, 512, 128).col_blocks == 1
    assert fa.plan(128, 128, 512, 257) is None
    assert fa.plan(128, 128, 512, 0) is None
    assert fa.plan(96, 128, 512, 64) is None
    assert fa.plan(128, 128, 512, 64, torch.float64) is None
    assert not fa.fits({"block_q": 96, "block_kv": 128}, {"seq": 512})
    assert fa.INSTANTIATIONS == tuple(
        (b, dm, *sh) for b in (0, 1) for dm in (64, 128, 256)
        for sh in ((fa.WIDE, fa.NARROW) if dm <= 128 else (fa.NARROW,)))


def _attn_mirror(q, k, v, block_q, block_kv, causal, window, pl, *,
                 kv_len=None, skip_alpha_at=None, short=0,
                 no_len_mask=False):
    """csrc/flash_attention.cu's walk in numpy, on float32: blocks heaviest
    first, each walking its q tile in sub-tiles of ``pl.sub_q`` rows (q
    staged with rows clamped to the sequence and zero columns past d),
    the visited kv tiles in sub-tiles of ``pl.sub_kv``; per sub-tile the
    scores of row group g's rows r·groups + g against lane t's columns
    c·8 + t, masks only where the sub-tile needs them (-inf past the
    tile), each lane's partial max and in-order sum over its columns,
    then the group's over its 8 lanes (a butterfly of xor 1, 2, 4), the
    alpha rescale, p handed to the group's slice and read by its pair of
    groups row by kv row, and acc / max(l, 1e-30) for the tile's rows.
    Keys from ``kv_len`` on (default: none) are a pad: the walk ends at the
    sub-tile holding key kv_len - 1 and masks the pad where a sub-tile
    holds some. ``skip_alpha_at`` (drop the alpha rescale on that sub-tile
    of every walk), ``short`` (visit that many kv tiles fewer) and
    ``no_len_mask`` (leave the pad unmasked) mutate it to show the test can
    fail."""
    f32 = np.float32
    bh, s, d = q.shape
    kv_len = k.shape[1] if kv_len is None else kv_len
    group = bh // k.shape[0]
    ng, nr, sq, skv, dm = pl.groups, pl.rows, pl.sub_q, pl.sub_kv, pl.d_max
    ncol = skv // 8
    scale = f32(1.0 / d ** 0.5)
    rows = np.arange(nr)[:, None] * ng + np.arange(ng)[None, :]   # (R, G)
    lanes = np.arange(8)
    cols = np.arange(ncol)[None, :] * 8 + lanes[:, None]          # (8, C)
    # a pair's row a: row a % R of its group 2·pair + a // R
    pair_rows = ((np.arange(2 * nr) % nr)[None, :] * ng
                 + 2 * np.arange(ng // 2)[:, None]
                 + (np.arange(2 * nr) // nr)[None, :])            # (G/2, 2R)

    def by_pair(x):  # (R, G) -> (G/2, 2R)
        return x.T.reshape(ng // 2, 2, nr).reshape(ng // 2, 2 * nr)

    def staged(x, first, n):
        out = np.zeros((n, dm), f32)
        out[:, :d] = x[np.minimum(first + np.arange(n), len(x) - 1)]
        return out

    out = np.full(q.shape, np.nan, f32)
    n_q = s // block_q
    subs = -(-block_kv // skv)
    for b in range(bh * n_q):
        qi, h = n_q - 1 - b // bh, b % bh
        q_begin = qi * block_q
        end = -(-kv_len // block_kv)
        if causal:
            end = min(end, (q_begin + block_q - 1) // block_kv + 1)
        begin = 0
        if window:
            lo = q_begin - window + 1
            begin = lo // block_kv if lo > 0 else 0
        last_rows = min(block_kv, kv_len - (end - 1) * block_kv)
        n_sub = ((end - begin - 1) * subs + -(-last_rows // skv)
                 if end > begin else 0) - short * subs
        for qs0 in range(0, block_q, sq):
            q0 = q_begin + qs0
            qt = staged(q[h], q0, sq)
            m = np.full((nr, ng), -1e30, f32)
            l = np.zeros((nr, ng), f32)
            acc = np.zeros((ng // 2, 2 * nr, dm), f32)
            for u in range(n_sub):
                ks0 = u % subs * skv
                kv0 = (begin + u // subs) * block_kv + ks0
                n_cols = min(skv, block_kv - ks0)
                kt = staged(k[h // group], kv0, skv)
                vt = staged(v[h // group], kv0, skv)
                x = (qt @ kt.T)[rows[:, :, None, None],
                                cols[None, None]] * scale          # (R,G,8,C)
                if (n_cols < skv or (causal and kv0 + skv - 1 > q0) or
                        (window and q0 + sq - 1 - kv0 >= window) or
                        kv0 + skv > kv_len):
                    q_pos = q0 + rows[:, :, None, None]
                    kv_pos = kv0 + cols[None, None]
                    masked = np.zeros(x.shape, bool)
                    if causal:
                        masked |= q_pos < kv_pos
                    if window:
                        masked |= q_pos - kv_pos >= window
                    if not no_len_mask:
                        masked |= kv_pos >= kv_len
                    x = np.where(masked, f32(-1e30), x)
                    x = np.where(cols[None, None] >= n_cols, f32(-np.inf), x)
                m_new = np.maximum(m, x.max(axis=3).max(axis=2))
                alpha = np.exp(m - m_new)
                if u == skip_alpha_at:
                    alpha = np.ones_like(alpha)
                p = np.exp(x - m_new[:, :, None, None])
                part = p[..., 0]
                for c in range(1, ncol):
                    part = part + p[..., c]
                for xor in (1, 2, 4):
                    part = part + part[:, :, lanes ^ xor]
                l = l * alpha + part[:, :, 0]
                m = m_new
                # the slices: slice g holds row r's p of kv row j at [g, j, r]
                slices = np.empty((ng, skv, nr), f32)
                slices[:, cols.ravel(), :] = p.transpose(1, 2, 3, 0).reshape(
                    ng, 8 * ncol, nr)
                pair_p = slices.reshape(ng // 2, 2, skv, nr).transpose(
                    0, 2, 1, 3).reshape(ng // 2, skv, 2 * nr)
                acc = acc * by_pair(alpha)[:, :, None]
                for j in range(skv):
                    acc = acc + pair_p[:, j, :, None] * vt[j][None, None, :]
            o = acc / np.maximum(by_pair(l), f32(1e-30))[:, :, None]
            keep = qs0 + pair_rows < block_q
            out[h, q0 + pair_rows[keep]] = o[keep][:, :d]
    return out


# (q heads, kv heads, tokens, d, block_q, block_kv, causal, window, shape)
MIRROR_CASES = [
    (4, 2, 256, 64, 128, 128, True, None, None),
    (4, 2, 256, 64, 64, 256, True, 64, None),        # narrow block, window
    (6, 2, 256, 64, 256, 128, False, None, None),    # two q sub-tiles
    (2, 1, 192, 66, 96, 48, True, None, None),       # part sub-tiles, d 66
    (4, 2, 512, 64, 128, 128, True, 100, None),      # window across sub-tiles
    (2, 1, 128, 1, 64, 64, True, None, None),        # d 1
    (2, 1, 256, 128, 64, 128, False, 100, None),
    (4, 2, 256, 64, 128, 128, True, None, "NARROW"),  # two 64-row sub-tiles
]


@pytest.mark.parametrize("bh,bh_kv,s,d,bq,bkv,causal,window,shape",
                         MIRROR_CASES)
def test_attention_mirror_of_the_kernel_walk_equals_plain_and_pallas(
        bh, bh_kv, s, d, bq, bkv, causal, window, shape):
    rng = np.random.default_rng(11)
    q = _randn(rng, (bh, s, d))
    k, v = _randn(rng, (bh_kv, s, d)), _randn(rng, (bh_kv, s, d))
    pl = fa.plan(bq, bkv, s, d)
    if shape:  # the walk of a block shape plan does not pick for this tile
        threads, sub_kv = getattr(fa, shape)
        pl = dataclasses.replace(pl, threads=threads, sub_kv=sub_kv)
    out = _attn_mirror(q, k, v, bq, bkv, causal, window, pl)
    plain = fa.attention_plain(*map(torch.from_numpy, (q, k, v)),
                               causal=causal, window=window).numpy()
    np.testing.assert_allclose(out, plain, rtol=RTOL["float32"],
                               atol=RTOL["float32"])
    ref = np.asarray(ref_fa.flash_attention(
        *map(jnp.asarray, (q, k, v)), block_q=bq, block_kv=bkv,
        causal=causal, window=window, interpret=True))
    np.testing.assert_allclose(out, ref, rtol=RTOL["float32"],
                               atol=RTOL["float32"])


@pytest.mark.parametrize("mutation", [{"skip_alpha_at": 1}, {"short": 1}])
def test_attention_mirror_fails_when_mutated(mutation):
    """The mirror test can fail: the alpha rescale left out on one
    sub-tile, or the visited kv tiles' bound one tile short."""
    rng = np.random.default_rng(11)
    q = _randn(rng, (4, 256, 64))
    k, v = _randn(rng, (2, 256, 64)), _randn(rng, (2, 256, 64))
    pl = fa.plan(128, 128, 256, 64)
    plain = fa.attention_plain(*map(torch.from_numpy, (q, k, v))).numpy()
    out = _attn_mirror(q, k, v, 128, 128, True, None, pl, **mutation)
    assert not np.allclose(out, plain, rtol=RTOL["float32"],
                           atol=RTOL["float32"])


# (q heads, kv heads, queries, keys, kv_len, d, block_q, block_kv, causal,
# window): keys padded to the kv tile with kv_len the real ones
MIRROR_CROSS_CASES = [
    (4, 2, 256, 1536, 1500, 64, 128, 128, False, None),  # whisper's cross
    (4, 4, 1536, 1536, 1500, 64, 128, 128, False, None),  # its encoder
    (2, 1, 64, 192, 131, 66, 64, 96, False, None),  # narrow, part sub-tiles
    (2, 2, 128, 128, 70, 16, 64, 64, True, None),   # causal, pad keys
    (2, 1, 128, 128, 100, 16, 128, 128, True, 32),  # window, pad keys
]


@pytest.mark.parametrize("bh,bh_kv,sq,skv,kv_len,d,bq,bkv,causal,window",
                         MIRROR_CROSS_CASES)
def test_attention_mirror_across_lengths_equals_plain_and_reference(
        bh, bh_kv, sq, skv, kv_len, d, bq, bkv, causal, window):
    """The walk with Sq != Skv and a key-length bound against
    ``attention_plain(kv_len=...)`` and, on the real keys alone, the
    reference's ``blockwise_attention`` (the Pallas kernel takes one S);
    under a mask, the real query rows only (the pad rows' are sliced off
    by the caller)."""
    rng = np.random.default_rng(sq + skv)
    q = _randn(rng, (bh, sq, d))
    k, v = _randn(rng, (bh_kv, skv, d)), _randn(rng, (bh_kv, skv, d))
    pl = fa.plan(bq, bkv, sq, d, skv=skv)
    out = _attn_mirror(q, k, v, bq, bkv, causal, window, pl, kv_len=kv_len)
    plain = fa.attention_plain(*map(torch.from_numpy, (q, k, v)),
                               causal=causal, window=window,
                               kv_len=kv_len).numpy()
    rows = kv_len if causal else sq
    np.testing.assert_allclose(out[:, :rows], plain[:, :rows],
                               rtol=RTOL["float32"], atol=RTOL["float32"])
    ref = np.asarray(ref_attn.blockwise_attention(
        jnp.asarray(q[:, :rows].transpose(1, 0, 2)[None]),
        *(jnp.asarray(x[:, :kv_len].transpose(1, 0, 2)[None])
          for x in (k, v)), causal=causal, window=window))[0]
    np.testing.assert_allclose(out[:, :rows], ref.transpose(1, 0, 2),
                               rtol=RTOL["float32"], atol=RTOL["float32"])


def test_attention_mirror_fails_without_the_length_mask():
    """The cross-length mirror test can fail: the pad keys left unmasked
    on the sub-tile that straddles kv_len."""
    rng = np.random.default_rng(12)
    q = _randn(rng, (2, 64, 16))
    k, v = _randn(rng, (1, 128, 16)), _randn(rng, (1, 128, 16))
    pl = fa.plan(64, 128, 64, 16, skv=128)
    plain = fa.attention_plain(*map(torch.from_numpy, (q, k, v)),
                               causal=False, kv_len=100).numpy()
    assert np.allclose(_attn_mirror(q, k, v, 64, 128, False, None, pl,
                                    kv_len=100), plain,
                       rtol=RTOL["float32"], atol=RTOL["float32"])
    out = _attn_mirror(q, k, v, 64, 128, False, None, pl, kv_len=100,
                       no_len_mask=True)
    assert not np.allclose(out, plain, rtol=RTOL["float32"],
                           atol=RTOL["float32"])


def test_flash_attention_takes_lengths_and_a_bound_on_the_cpu():
    """The wrapper's checks of Sq, Skv and kv_len, and its CPU dispatch
    (``attention_plain`` with the bound): a bound outside 1..Skv, a mask
    across lengths and a kv tile not dividing Skv are refused; lse is
    (BH, Sq)."""
    q, k = torch.randn(2, 64, 16), torch.randn(1, 192, 16)
    out, lse = fa.flash_attention(q, k, k, block_q=64, block_kv=64,
                                  causal=False, kv_len=150, return_lse=True)
    assert out.shape == (2, 64, 16) and lse.shape == (2, 64)
    want = fa.attention_plain(q, k[:, :150], k[:, :150], causal=False)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    for bad in (0, 193):
        with pytest.raises(ValueError, match="kv_len"):
            fa.flash_attention(q, k, k, block_q=64, block_kv=64,
                               causal=False, kv_len=bad)
    for kw in ({"causal": True}, {"causal": False, "window": 16}):
        with pytest.raises(ValueError, match="as many queries as keys"):
            fa.flash_attention(q, k, k, block_q=64, block_kv=64, **kw)
    with pytest.raises(AssertionError):
        fa.flash_attention(q, k, k, block_q=64, block_kv=128, causal=False)
    assert fa.plan(64, 128, 64, 16, skv=192) is None
    assert fa.plan(64, 64, 64, 16, skv=192) == fa.plan(64, 64, 64, 16)


def test_make_live_without_cuda_raises_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for mod in (fa, ssd):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.make_live()


@pytest.mark.parametrize("mod", [fa, ssd])
def test_make_live_inputs_follow_the_reference_distributions(mod):
    """Seeded inputs on the CPU: the same seed gives the same tensors, and
    the SSD's dt and a lie in the reference's ranges."""
    seen = []
    real = mod.launch  # the live objective launches without the operator

    def spy(*args, **kw):
        seen.append(args)
        return real(*args, **kw)

    name = "launch"
    conf = get_kernel(NAMES[mod]).space().as_dict(
        get_kernel(NAMES[mod]).space().valid_configs[0])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, name, spy)
        for seed in (3, 3, 4):
            mod.make_live({"seed": seed}, device="cpu")(conf)
    assert all(torch.equal(a, b) for a, b in zip(seen[0], seen[1]))
    assert not torch.equal(seen[0][0], seen[2][0])
    assert all(t.dtype == torch.float32 for t in seen[0])
    if mod is ssd:
        _, dt, a, _, _ = seen[0]
        assert 0.001 <= dt.min() and dt.max() <= 0.1
        assert -1.5 <= a.min() and a.max() <= -0.5


# ------------------------------------------------------ record and merge
@pytest.mark.parametrize("name", ["flash_attention", "ssd"])
def test_cpu_record_merge_round_trip(tmp_path, name):
    """A live recording at SMOKE_PROBLEM on the CPU (the plain versions);
    its shard merges to the same cache through the reference's
    ``merge_shards``, over the registry space."""
    out = str(tmp_path / f"{name}.json.gz")
    spec = record.RecordSpec.create(name, target="cpu", max_evals=8,
                                    repeats=1, seed=2)
    cache = record.record_cache(spec, out)
    assert (cache.kernel, cache.device) == (name, "cpu")
    assert len(cache.results) == 8
    assert cache.space.size == get_kernel(name).space().size
    assert all(r.status == "ok" and len(r.times_s) == 1
               for r in cache.results.values())
    shard = record.shard_path(out[:-len(".json.gz")], 0)
    ref = ref_merge_shards([shard])
    assert {k: result_to_json(r) for k, r in cache.results.items()} == \
        {k: ref_result_to_json(r) for k, r in ref.results.items()}
    assert (ref.kernel, ref.device) == (name, "cpu")
    merged = record.merge_shards([shard], space=record.registry_space(
        name, spec.problem_dict))
    assert list(merged.results) == list(cache.results)


"""The port's convolution, hotspot and dedispersion against the reference.

On the CPU each wrapper takes its kernel's plain PyTorch version. Both the
plain version and the CPU wrapper are held here against the reference's
Pallas kernel in interpret mode, on the same numpy-seeded arrays, with the
tolerances of tests/test_kernels.py: 1e-3 for the convolution (a 289-tap
float32 sum), 1e-4 for hotspot and dedispersion. The spaces, config ids,
cost-model workloads and delay table must equal the reference's exactly.
The CUDA kernels themselves are compared with the plain versions on the
card by chip_smoke.py and tests/test_torch_cuda.py.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cache import result_to_json as ref_result_to_json
from repro.core.costmodel import estimate as ref_estimate
from repro.core.devices import HUB_DEVICES as REF_DEVICES
from repro.core.record import merge_shards as ref_merge_shards
from repro.kernels import ALL_KERNELS as REF_ALL_KERNELS
from repro.kernels import KERNELS as REF_KERNELS
from repro.kernels import convolution as ref_cv
from repro.kernels import dedispersion as ref_dd
from repro.kernels import hotspot as ref_hs
from repro_torch.core import record
from repro_torch.core.budget import Budget
from repro_torch.core.cache import result_to_json
from repro_torch.core.costmodel import estimate
from repro_torch.core.devices import DEVICES_BY_NAME
from repro_torch.core.runner import LiveRunner
from repro_torch.kernels import (ALL_KERNELS, FRAMEWORK_KERNELS, HUB_KERNELS,
                                 get_kernel)
from repro_torch.kernels import convolution as cv
from repro_torch.kernels import dedispersion as dd
from repro_torch.kernels import hotspot as hs

CONV_CASES = [  # tests/test_kernels.py's sweep
    (64, 128, 5, 5, 32, 128),
    (96, 130, 3, 7, 48, 96),          # padded width
    (128, 256, 17, 17, 16, 128),      # hub filter size
]
HOT_T_BLOCKS = [1, 2, 4]
DEDISP_TILINGS = [(8, 256), (4, 192), (16, 128), (12, 384)]

PAIRS = [(cv, ref_cv, 3360), (hs, ref_hs, 5040), (dd, ref_dd, 4320)]
NAMES = {cv: "convolution", hs: "hotspot", dd: "dedispersion"}


def _randn(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)


# ------------------------------------------------------- kernel arithmetic
@pytest.mark.parametrize("h,w,fh,fw,sh,bw", CONV_CASES)
def test_conv_matches_pallas_interpret(h, w, fh, fw, sh, bw):
    x, f = _randn(1, (h, w)), _randn(2, (fh, fw))
    ref = np.asarray(ref_cv.conv2d(jnp.asarray(x), jnp.asarray(f), strip_h=sh,
                                   block_w=bw, interpret=True))
    xt, ft = torch.from_numpy(x), torch.from_numpy(f)
    before = cv.launches
    for out in (cv.conv2d_plain(xt, ft),
                cv.conv2d(xt, ft, strip_h=sh, block_w=bw)):
        assert out.dtype == torch.float32 and out.shape == (h, w)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-3, atol=1e-3)
    assert cv.launches == before


@pytest.mark.parametrize("tb", HOT_T_BLOCKS)
def test_hotspot_matches_pallas_interpret(tb):
    t, p = _randn(3, (64, 128)), _randn(4, (64, 128), 0.1)
    ref = np.asarray(ref_hs.hotspot(jnp.asarray(t), jnp.asarray(p),
                                    strip_h=32, block_w=128, t_block=tb,
                                    interpret=True))
    tt, pt = torch.from_numpy(t), torch.from_numpy(p)
    before = hs.launches
    for out in (hs.hotspot_plain(tt, pt, t_block=tb),
                hs.hotspot(tt, pt, strip_h=32, block_w=128, t_block=tb)):
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)
    # the plain version is the reference's oracle, operation for operation
    assert np.array_equal(hs.hotspot_plain(tt, pt, t_block=tb).numpy(),
                          np.asarray(ref_hs.hotspot_ref(
                              jnp.asarray(t), jnp.asarray(p), t_block=tb)))
    assert hs.launches == before


@pytest.mark.parametrize("bdm,bt", DEDISP_TILINGS)
def test_dedispersion_matches_pallas_interpret(bdm, bt):
    x = _randn(5, (32, 768 + dd.MAX_DELAY))
    delays = np.asarray(ref_dd.make_delays(32, 24))
    ref = np.asarray(ref_dd.dedisperse(jnp.asarray(x), jnp.asarray(delays),
                                       block_dm=bdm, block_t=bt,
                                       interpret=True))
    xt, dt = torch.from_numpy(x), torch.from_numpy(delays.copy())
    before = dd.launches
    for out in (dd.dedisperse_plain(xt, dt),
                dd.dedisperse(xt, dt, block_dm=bdm, block_t=bt)):
        assert out.shape == ref.shape == (24, 768)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)
    assert dd.launches == before


def test_dedispersion_clamps_delays_like_dynamic_slice():
    """A delay past MAX_DELAY reads the last in-range segment, as the
    reference's clamped ``dynamic_slice`` start does."""
    x = _randn(6, (4, 128 + dd.MAX_DELAY))
    delays = np.full((4, 3), dd.MAX_DELAY + 40, np.int32)
    ref = np.asarray(ref_dd.dedisperse(jnp.asarray(x), jnp.asarray(delays),
                                       block_dm=3, block_t=128,
                                       interpret=True))
    out = dd.dedisperse(torch.from_numpy(x), torch.from_numpy(delays),
                        block_dm=3, block_t=128)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("nchan,ndm", [(32, 24), (256, 256), (7, 13),
                                       (64, 96)])
def test_make_delays_equals_reference_exactly(nchan, ndm):
    ours = dd.make_delays(nchan, ndm)
    ref = np.asarray(ref_dd.make_delays(nchan, ndm))
    assert ours.dtype == torch.int32
    assert np.array_equal(ours.numpy(), ref)


# -------------------------------------------------- spaces and cost model
@pytest.mark.parametrize("ours,ref,size", PAIRS)
def test_space_identical_to_reference(ours, ref, size):
    a, b = ours.space(), ref.space()
    assert a.size == b.size == size
    assert [(t.name, t.values) for t in a.tunables] == \
        [(t.name, t.values) for t in b.tunables]
    assert a.valid_configs == b.valid_configs
    assert [a.config_id(c) for c in a.valid_configs] == \
        [b.config_id(c) for c in b.valid_configs]
    assert ours.SMOKE_PROBLEM == ref.SMOKE_PROBLEM
    assert ours.BYTES == ref.BYTES
    smoke_a = get_kernel(NAMES[ours]).space()
    smoke_b = ref.space(**ref.SMOKE_PROBLEM)
    assert smoke_a.valid_configs == smoke_b.valid_configs


def test_hub_constants_equal_reference():
    assert (cv.HUB_H, cv.HUB_W, cv.HUB_FH, cv.HUB_FW) == \
        (ref_cv.HUB_H, ref_cv.HUB_W, ref_cv.HUB_FH, ref_cv.HUB_FW)
    assert (hs.HUB_H, hs.HUB_W, hs.HUB_STEPS) == \
        (ref_hs.HUB_H, ref_hs.HUB_W, ref_hs.HUB_STEPS)
    assert (hs.C_CENTER, hs.C_NEIGH, hs.C_POWER) == \
        (ref_hs.C_CENTER, ref_hs.C_NEIGH, ref_hs.C_POWER)
    assert (dd.HUB_NCHAN, dd.HUB_NTIME, dd.HUB_NDM, dd.MAX_DELAY) == \
        (ref_dd.HUB_NCHAN, ref_dd.HUB_NTIME, ref_dd.HUB_NDM,
         ref_dd.MAX_DELAY)


@pytest.mark.parametrize("ours,ref,size", PAIRS)
def test_workload_matches_reference(ours, ref, size):
    space = ours.space()
    for conf in space.valid_configs[::379]:
        d = space.as_dict(conf)
        for dev in REF_DEVICES:
            a = estimate(ours.workload(), d, DEVICES_BY_NAME[dev.name], "x")
            b = ref_estimate(ref.workload(), d, dev, "x")
            assert (a.status, a.time_s, a.compile_s) == \
                (b.status, b.time_s, b.compile_s)


# ---------------------------------------------------------------- fitting
@pytest.mark.parametrize("ours,ref,size", PAIRS)
def test_every_hub_tiling_fits(ours, ref, size):
    """The kernels walk a tile too large for one block in sub-tiles, so
    no tiling of the hub spaces is rejected (the GEMM's 7,096 of 10,140
    are)."""
    space = ours.space()
    assert all(ours.fits(space.as_dict(c)) for c in space.valid_configs)


def test_fits_rejects_what_the_kernels_cannot_run():
    assert not cv.fits({"strip_h": 8, "block_w": 96}, {"fh": 35, "fw": 3})
    assert cv.fits({"strip_h": 8, "block_w": 96}, {"fh": 33, "fw": 33})
    assert not hs.fits({"strip_h": 48, "block_w": 128, "t_block": 1})
    assert not hs.fits({"strip_h": 64, "block_w": 128, "t_block": 64},
                       {"h": 64, "w": 128})
    assert not dd.fits({"block_dm": 8, "block_t": 128}, {"nchan": 5995})
    assert dd.fits({"block_dm": 8, "block_t": 128}, {"nchan": 5994})


# (block_dm, block_t) -> (G, T, warps_dm, warps_t, chans, stage floats,
# shared bytes) at the hub size
DEDISP_PLANS = {
    (1, 128): (1, 4, 1, 1, 4, 528, 10512),        # one warp, no halo
    (4, 192): (4, 2, 1, 3, 8, 2080, 38416),       # T 2: 192 = 3 x 64
    (12, 384): (4, 4, 3, 1, 12, 2096, 46864),     # three warps along dm
    (32, 512): (8, 4, 4, 2, 16, 4672, 108560),    # the hub tiling
    (128, 3968): (8, 4, 4, 2, 16, 4672, 108560),  # 4 dm groups, 16 sub-tiles
}


@pytest.mark.parametrize("tiling", sorted(DEDISP_PLANS))
def test_dedisp_plan_classes_are_pinned(tiling):
    pl = dd.plan(*tiling)
    assert (pl.dms_per_thread, pl.samples_per_thread, pl.warps_dm,
            pl.warps_t, pl.chans, pl.stage_floats, pl.shared_bytes) == \
        DEDISP_PLANS[tiling]
    assert pl.stages == dd.STAGES


def test_dedisp_plan_runs_every_hub_tiling_with_its_threads_busy():
    """``plan`` refuses 0 of the 4,320 hub tilings, stays within a block's
    shared memory and threads, and uses its threads: a dm group divides
    block_dm, sub-tiles pad block_t by at most 1/16, and every (G, T)
    instantiation of the kernel is reached."""
    space = dd.space()
    tilings = [(c["block_dm"], c["block_t"])
               for c in map(space.as_dict, space.valid_configs)]
    plans = {t: dd.plan(*t) for t in tilings}
    assert len(tilings) == 4320
    assert sum(p is None for p in plans.values()) == 0
    for (bdm, bt), pl in plans.items():
        assert pl.shared_bytes <= dd.MAX_SMEM_BYTES == 232448
        assert pl.threads <= dd.MAX_THREADS and pl.chans <= dd.MAX_CHANS
        assert bdm % pl.group == 0
        assert 16 * (-(-bt // pl.sub_t) * pl.sub_t - bt) <= bt
        assert pl.stage_floats >= pl.sub_t + 4 + (
            dd.MAX_DELAY if pl.group > 1 else 0)
    assert {(p.dms_per_thread, p.samples_per_thread)
            for p in plans.values()} == {
        (g, t) for g in dd.DMS_PER_THREAD for t in dd.SAMPLES_PER_THREAD}


# (strip_h, block_w, fh, fw) -> (instantiation, R, C, threads x, threads y,
# stages, pitch, shared bytes)
CONV_PLANS = {
    (64, 256, 17, 17): (17, 8, 4, 64, 4, 2, 272, 105808),   # the hub tiling
    (48, 320, 17, 17): (17, 8, 4, 80, 3, 2, 336, 108880),   # non-dividing
    (24, 256, 17, 17): (17, 8, 4, 64, 3, 2, 272, 88400),    # one sub-tile
    (8, 96, 17, 17): (17, 8, 4, 24, 1, 2, 112, 22864),      # smallest tile
    (512, 4096, 17, 17): (17, 8, 4, 128, 4, 2, 528, 204112),  # 8 blocks
    (64, 256, 9, 9): (0, 4, 4, 64, 4, 3, 264, 76464),       # run-time width
}
CONV_FILTERS = [(17, 17), (3, 3), (5, 5), (3, 7), (9, 9), (33, 33), (1, 1)]
# the most a hub tiling's padded sub-tiles leave idle of its lanes: (8,160)
# runs 40 threads, 2 warps of which 1.25 work
CONV_IDLE_LANES = 0.375


@pytest.mark.parametrize("tiling", sorted(CONV_PLANS))
def test_conv_plan_classes_are_pinned(tiling):
    pl = cv.plan(*tiling)
    assert (pl.filter_width, pl.rows, pl.cols, pl.threads_x, pl.threads_y,
            pl.stages, pl.pitch, pl.shared_bytes) == CONV_PLANS[tiling]
    assert pl.rows == cv.INSTANTIATIONS[pl.filter_width]


def test_conv_plan_runs_every_hub_tiling_with_its_lanes_busy():
    """``plan`` refuses 0 of the 3,360 hub tilings, stays within a block's
    shared memory and threads with a ring of 2 or 3 stages, reaches every
    instantiation over the filters the repository runs, and pads a hub
    tile to whole sub-tiles and warps leaving at most
    ``CONV_IDLE_LANES`` of its lanes idle."""
    space = cv.space()
    configs = [space.as_dict(c) for c in space.valid_configs]
    assert len(configs) == 3360
    assert sum(cv.plan(c["strip_h"], c["block_w"]) is None
               for c in configs) == 0
    tilings = {(c["strip_h"], c["block_w"]) for c in configs}
    reached, worst = set(), 0.0
    for (sh, bw), (fh, fw) in itertools.product(sorted(tilings),
                                                CONV_FILTERS):
        pl = cv.plan(sh, bw, fh, fw)
        assert pl.shared_bytes <= cv.MAX_SMEM_BYTES == 232448
        assert pl.threads <= cv.MAX_THREADS <= 1024
        assert 2 <= pl.stages <= cv.MAX_STAGES
        assert pl.pitch % 4 == 0 and pl.pitch >= pl.sub_w + fw - 1
        reached.add((pl.filter_width, pl.rows))
        if (fh, fw) == (17, 17):
            lanes = (pl.sub_tiles(sh, bw) * -(-pl.threads // 32) * 32
                     * pl.rows * pl.cols)
            worst = max(worst, 1 - sh * bw / lanes)
    assert reached == set(cv.INSTANTIATIONS.items())
    assert worst == CONV_IDLE_LANES


def test_conv_fits_accepts_what_it_accepted_before_plan():
    """``fits`` is true exactly where the kernel it replaced took the
    problem: both filter sides at most 33 taps and at most 65,535 row
    tiles."""
    for fh, fw, h, sh in itertools.product((1, 2, 17, 33, 34), (1, 4, 33, 35),
                                           (64, 4096, 65535 * 8 + 1),
                                           (8, 512)):
        want = max(fh, fw) <= 33 and -(-h // sh) <= 65535
        assert cv.fits({"strip_h": sh, "block_w": 96},
                       {"h": h, "fh": fh, "fw": fw}) == want


def _conv_mirror(x: np.ndarray, f: np.ndarray, strip_h: int,
                 block_w: int) -> np.ndarray:
    """csrc/convolution.cu's index walk in numpy, on float32: per block its
    sub-tiles in order through the ring (prologue fills, then each step
    fills ``stages - 1`` ahead into the stage read last, then computes),
    each staged row as its 16-byte pieces with zeros outside the image and
    NaN past them, each thread's R x C patch from float4 windows of
    ``pitch``-wide rows, taps dy outer, dx inner, multiply then add."""
    h, w = x.shape
    fh, fw = f.shape
    pl = cv.plan(strip_h, block_w, fh, fw)
    r_, c_, txn, tyn = pl.rows, pl.cols, pl.threads_x, pl.threads_y
    sub_h, sub_w, pitch = pl.sub_h, pl.sub_w, pl.pitch
    rows_h = sub_h + fh - 1
    staged = 4 * -(-(sub_w + fw - 1) // 4)
    nwin = 4 * -(-(c_ + fw - 1) // 4)
    fs = np.zeros((fh, 4 * -(-fw // 4)), np.float32)
    fs[:, :fw] = f
    ph, pw = fh // 2, fw // 2
    out = np.full((h, w), np.nan, np.float32)
    ring = np.full((pl.stages, rows_h, pitch), np.nan, np.float32)
    ty, tx = np.meshgrid(np.arange(tyn), np.arange(txn), indexing="ij")
    for tr0 in range(0, h, strip_h):
        for tc0 in range(0, w, block_w):
            tr1, tc1 = min(tr0 + strip_h, h), min(tc0 + block_w, w)
            n_sub_x = -(-(tc1 - tc0) // sub_w)
            n_sub = n_sub_x * -(-(tr1 - tr0) // sub_h)

            def fill(s):
                sy, sx = divmod(s, n_sub_x)
                gr = tr0 + sy * sub_h - ph + np.arange(rows_h)[:, None]
                gc = tc0 + sx * sub_w - pw + np.arange(staged)[None, :]
                inside = (gr >= 0) & (gr < h) & (gc >= 0) & (gc < w)
                stage = ring[s % pl.stages]
                stage[:] = np.nan
                stage[:, :staged] = np.where(
                    inside, x[np.clip(gr, 0, h - 1), np.clip(gc, 0, w - 1)],
                    np.float32(0))

            for s in range(pl.stages - 1):
                if s < n_sub:
                    fill(s)
            for s in range(n_sub):
                if s + pl.stages - 1 < n_sub:
                    fill(s + pl.stages - 1)
                sy, sx = divmod(s, n_sub_x)
                stage = ring[s % pl.stages]
                acc = np.zeros((tyn, txn, r_, c_), np.float32)
                for dy in range(fh):
                    for i in range(r_):
                        win = stage[(ty * r_ + i + dy)[..., None],
                                    (tx * c_)[..., None] + np.arange(nwin)]
                        for dx in range(fw):
                            acc[:, :, i] = (acc[:, :, i]
                                            + win[:, :, dx:dx + c_]
                                            * fs[dy, dx])
                r0 = tr0 + sy * sub_h + ty * r_
                c0 = tc0 + sx * sub_w + tx * c_
                for i, c in itertools.product(range(r_), range(c_)):
                    row, col = r0 + i, c0 + c
                    keep = (row < tr1) & (col < tc1)
                    out[row[keep], col[keep]] = acc[:, :, i, c][keep]
    return out


@pytest.mark.parametrize("h,w,fh,fw,sh,bw", [
    (96, 130, 3, 7, 48, 96),          # the 130-wide test image
    (40, 52, 3, 3, 16, 96),           # fw 3
    (70, 90, 17, 17, 24, 96),         # the hub filter, ragged tiles
    (50, 70, 33, 33, 8, 96),          # fw 33: the run-time width
    (37, 45, 9, 9, 16, 128),          # the run-time width, 3-stage ring
    (20, 30, 5, 5, 512, 4096),        # a tile larger than the image
    (150, 200, 17, 17, 512, 4096),    # ... with several sub-tiles
    (33, 259, 7, 7, 8, 96),           # odd width, many 8-row tiles
])
def test_conv_mirror_of_the_kernel_walk_equals_plain(h, w, fh, fw, sh, bw):
    x, f = _randn(3, (h, w)), _randn(4, (fh, fw))
    out = _conv_mirror(x, f, sh, bw)
    assert torch.equal(torch.from_numpy(out),
                       cv.conv2d_plain(torch.from_numpy(x),
                                       torch.from_numpy(f)))


# (strip_h, block_w, t_block) -> (threads x, threads y, sub_h, sub_w,
# sub-tiles a tile, shared bytes) at R = 16
HOT_PLANS = {
    (64, 512, 4): (96, 5, 64, 86, 6, 61440),        # the hub tiling
    (64, 512, 1): (96, 5, 64, 86, 6, 61440),
    (64, 512, 16): (128, 4, 32, 86, 12, 65536),     # 2 x 6 sub-tiles
    (8, 128, 3): (160, 1, 8, 128, 1, 20480),        # one run, one sub-tile
    (32, 128, 4): (160, 3, 32, 128, 1, 61440),      # the whole tile
    (256, 1024, 8): (96, 5, 64, 79, 52, 61440),     # 4 x 13 sub-tiles
    (1024, 4096, 16): (128, 4, 32, 96, 1376, 65536),  # the largest tile
}


@pytest.mark.parametrize("tiling", sorted(HOT_PLANS))
def test_hotspot_plan_classes_are_pinned(tiling):
    pl = hs.plan(*tiling)
    sh, bw, tb = tiling
    assert (pl.threads_x, pl.threads_y, pl.sub_h, pl.sub_w,
            pl.sub_tiles(sh, bw), pl.shared_bytes) == HOT_PLANS[tiling]
    assert (pl.t_block, pl.rows, pl.pitch) == (tb, hs.ROWS, pl.threads_x)


def test_hotspot_plan_runs_every_hub_tiling():
    """``plan`` refuses 0 of the 5,040 hub configs, stays within a block's
    threads and shared memory (two blocks an SM by both), holds each
    halo'd sub-tile in whole warps and runs, keeps sub-tiles inside the
    tile, and reaches every instantiation of the kernel."""
    space = hs.space()
    configs = [space.as_dict(c) for c in space.valid_configs]
    assert len(configs) == 5040
    plans = {(c["strip_h"], c["block_w"], c["t_block"]):
             hs.plan(c["strip_h"], c["block_w"], c["t_block"])
             for c in configs}
    assert len(plans) == 630 and sum(p is None for p in plans.values()) == 0
    for (sh, bw, tb), pl in plans.items():
        assert pl.shared_bytes <= hs.MAX_SMEM_BYTES <= 232448 // 2
        assert pl.shared_bytes == 2 * pl.threads_y * pl.rows * pl.pitch * 4
        assert pl.threads <= hs.MAX_THREADS and pl.threads_x % 32 == 0
        assert pl.sub_w + 2 * tb <= pl.threads_x < pl.sub_w + 2 * tb + 32
        assert pl.sub_h + 2 * tb <= pl.threads_y * pl.rows
        assert pl.sub_h + 2 * tb > (pl.threads_y - 1) * pl.rows
        assert 1 <= pl.sub_h <= sh and 1 <= pl.sub_w <= bw
    assert {p.rows for p in plans.values()} == {hs.ROWS}


def test_hotspot_launch_steps_and_plan_limits():
    """More than ``MAX_STEPS`` fused steps run as several launches of at
    most ``MAX_STEPS``; ``plan`` refuses what the kernel cannot run."""
    assert hs._launch_steps(16) == [16]
    assert hs._launch_steps(40) == [16, 16, 8]
    assert hs._launch_steps(32) == [16, 16]
    assert hs.plan(8, 128, 17) is None and hs.plan(0, 128, 1) is None
    assert hs.plan(8, 128, 0) is None and hs.plan(1, 1, 16) is not None


def _hot_mirror(t: np.ndarray, p: np.ndarray, strip_h: int, block_w: int,
                t_block: int, margin: int = 0, pitch_off: int = 0
                ) -> np.ndarray:
    """csrc/hotspot.cu's walk in numpy, on float32, one launch a chunk of
    ``hs._launch_steps``: per tile its sub-tiles in order (the last of a
    row or column moved back to the tile's edge), each halo'd sub-tile
    loaded once with the wrap only where it touches the grid's edge,
    P less its outer ring, threads' runs of R cells in registers, each
    step published to one of two flat planes of ``pitch``-wide rows,
    left and right read from the plane, up and down from the run except
    at its ends, cells inside the step's margin updated, the interior
    written. ``margin`` and ``pitch_off`` mutate it (a narrower pyramid,
    plane reads with a wrong pitch) to show the test can fail."""
    h, w = t.shape
    f32 = np.float32
    cur = t
    for steps in hs._launch_steps(t_block):
        pl = hs.plan(strip_h, block_w, steps)
        r_, tx, ty = pl.rows, pl.threads_x, pl.threads_y
        rows, pitch, tb = ty * r_, pl.pitch, steps
        sub_h, sub_w = pl.sub_h, pl.sub_w
        hh, hw = sub_h + 2 * tb, sub_w + 2 * tb
        out = np.full((h, w), np.nan, f32)
        planes = np.full((2, rows * pitch), np.nan, f32)
        row, col = np.arange(rows)[:, None], np.arange(tx)[None, :]
        parity = 0
        for tr in range(0, h, strip_h):
            for tc in range(0, w, block_w):
                for sy in range(-(-strip_h // sub_h)):
                    r0 = tr + min(sy * sub_h, strip_h - sub_h)
                    for sx in range(-(-block_w // sub_w)):
                        c0 = tc + min(sx * sub_w, block_w - sub_w)
                        edge = (r0 < tb or r0 + sub_h + tb > h or c0 < tb
                                or c0 + sub_w + tb > w)
                        gr = r0 - tb + row + 0 * col
                        gc = c0 - tb + col + 0 * row
                        if edge:
                            gr = np.where(gr < 0, gr + h,
                                          np.where(gr >= h, gr - h, gr))
                            gc = np.where(gc < 0, gc + w,
                                          np.where(gc >= w, gc - w, gc))
                        held = (row < hh) & (col < hw)
                        assert ((gr[held] >= 0) & (gr[held] < h)).all()
                        assert ((gc[held] >= 0) & (gc[held] < w)).all()
                        grc, gcc = np.clip(gr, 0, h - 1), np.clip(gc, 0, w - 1)
                        tv = np.where(held, cur[grc, gcc], f32(0))
                        inner = ((row >= 1) & (row < hh - 1) & (col >= 1)
                                 & (col < hw - 1))
                        pv = np.where(inner, p[grc, gcc], f32(0))
                        for s in range(1, tb + 1):
                            flat = planes[parity]
                            parity ^= 1
                            flat[(row * pitch + col).ravel()] = tv.ravel()
                            m = s + margin
                            rr, cc = np.nonzero((row >= m) & (row < hh - m)
                                                & (col >= m) & (col < hw - m))
                            q = rr * (pitch + pitch_off) + cc
                            for k in (q - 1, q + 1, q - pitch, q + pitch):
                                assert ((k >= 0) & (k < rows * pitch)).all()
                            top, bottom = rr % r_ == 0, rr % r_ == r_ - 1
                            up = np.where(top, flat[np.clip(q - pitch, 0, None)],
                                          tv[np.maximum(rr - 1, 0), cc])
                            down = np.where(
                                bottom, flat[np.clip(q + pitch, None,
                                                     rows * pitch - 1)],
                                tv[np.minimum(rr + 1, rows - 1), cc])
                            neigh = ((up + down) + flat[q - 1]) + flat[q + 1]
                            new = ((f32(hs.C_CENTER) * tv[rr, cc]
                                    + f32(hs.C_NEIGH) * neigh)
                                   + f32(hs.C_POWER) * pv[rr, cc])
                            tv = tv.copy()
                            tv[rr, cc] = new
                        keep = ((row >= tb) & (row < tb + sub_h)
                                & (col >= tb) & (col < tb + sub_w))
                        out[(r0 - tb + row + 0 * col)[keep],
                            (c0 - tb + col + 0 * row)[keep]] = tv[keep]
        cur = out
    return cur


HOT_MIRROR_CASES = [  # (h, w, strip_h, block_w, t_block)
    (64, 128, 32, 128, 1),
    (64, 128, 32, 128, 2),
    (64, 128, 32, 128, 4),
    (64, 128, 32, 128, 16),           # the hub's deepest pyramid
    (128, 512, 64, 512, 4),           # the hub tiling: 6 sub-tiles, last moved
    (80, 96, 40, 32, 3),              # non-square grid, narrow tiles
    (40, 36, 8, 12, 16),              # halo wider than the tile: wraps twice
    (48, 160, 48, 160, 20),           # two launches (16 + 4)
]


@pytest.mark.parametrize("h,w,sh,bw,tb", HOT_MIRROR_CASES)
def test_hotspot_mirror_of_the_kernel_walk_equals_plain(h, w, sh, bw, tb):
    t, p = _randn(3, (h, w)), _randn(4, (h, w), 0.1)
    out = _hot_mirror(t, p, sh, bw, tb)
    assert torch.equal(torch.from_numpy(out), hs.hotspot_plain(
        torch.from_numpy(t), torch.from_numpy(p), t_block=tb))


@pytest.mark.parametrize("mutation", [{"margin": 1}, {"pitch_off": 1}])
def test_hotspot_mirror_fails_when_mutated(mutation):
    """The mirror test can fail: a pyramid one cell too narrow, or plane
    reads one float off the pitch, change the result or read outside the
    planes."""
    h, w, sh, bw, tb = 64, 128, 32, 128, 4
    t, p = _randn(3, (h, w)), _randn(4, (h, w), 0.1)
    ref = hs.hotspot_plain(torch.from_numpy(t), torch.from_numpy(p),
                           t_block=tb)
    try:
        out = _hot_mirror(t, p, sh, bw, tb, **mutation)
    except AssertionError:
        return
    assert not torch.equal(torch.from_numpy(out), ref)


def test_rejections_raise_before_launch_on_the_cpu():
    """A tiling ``fits`` refuses raises ``ConfigRejected`` on CPU tensors
    too, so a CPU recording stores it as a failed config, like the card."""
    x = torch.zeros(64, 64)
    with pytest.raises(cv.ConfigRejected):
        cv.conv2d(x, torch.zeros(35, 3), strip_h=8, block_w=96)
    with pytest.raises(hs.ConfigRejected):
        hs.hotspot(x, x, strip_h=48, block_w=64, t_block=1)
    with pytest.raises(dd.ConfigRejected):
        dd.dedisperse(torch.zeros(1, 600).expand(27999, -1),
                      torch.zeros(27999, 2, dtype=torch.int32),
                      block_dm=1, block_t=128)
    assert issubclass(cv.ConfigRejected, ValueError)
    space = cv.space()
    runner = LiveRunner(space, lambda conf: cv.conv2d(
        x, torch.zeros(35, 3), strip_h=conf["strip_h"],
        block_w=conf["block_w"]), Budget(max_evals=1), repeats=1)
    assert runner.run(space.valid_configs[0]).status == "error"


def test_make_live_without_cuda_raises_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for mod in (cv, hs, dd):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.make_live()


# ------------------------------------------------------ record and merge
@pytest.mark.parametrize("name", ["convolution", "hotspot", "dedispersion"])
def test_cpu_record_merge_round_trip(tmp_path, name):
    """A live recording at SMOKE_PROBLEM on the CPU (the plain versions);
    its shard merges to the same cache through the reference's
    ``merge_shards``, over the registry space."""
    out = str(tmp_path / f"{name}.json.gz")
    spec = record.RecordSpec.create(name, target="cpu", max_evals=12,
                                    repeats=1, seed=2)
    cache = record.record_cache(spec, out)
    assert (cache.kernel, cache.device) == (name, "cpu")
    assert len(cache.results) == 12
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


def test_registry_holds_the_four_hub_kernels():
    """The hub tier holds the paper's four kernels; the framework tier the
    reference's two others, and ``ALL_KERNELS`` both, as in the reference's
    registry."""
    assert sorted(HUB_KERNELS) == ["convolution", "dedispersion", "gemm",
                                   "hotspot"]
    for name, mod in HUB_KERNELS.items():
        spec = get_kernel(name)
        assert spec.module is mod and spec.tier == "hub"
    assert sorted(FRAMEWORK_KERNELS) == ["flash_attention", "ssd"]
    for name, mod in FRAMEWORK_KERNELS.items():
        spec = get_kernel(name)
        assert spec.module is mod and spec.tier == "framework"
    assert ALL_KERNELS == {**HUB_KERNELS, **FRAMEWORK_KERNELS}
    assert list(ALL_KERNELS) == list(REF_ALL_KERNELS)
    assert {n: get_kernel(n).tier for n in ALL_KERNELS} == \
        {n: s.tier for n, s in REF_KERNELS.items()}

"""Dedispersion — radio-astronomy signal reconstruction (benchmark-hub kernel).

Port of ``src/repro/kernels/dedispersion.py``: out[dm, t] = Σ_c x[c, t +
delay[c, dm]], a gather-reduce over the channels. The Pallas TPU kernel
``_dedisp_kernel``/``dedisperse`` becomes the hand-written CUDA kernel
``csrc/dedispersion.cu``; ``dedisperse`` here is its wrapper and
``dedisperse_plain`` the same function in plain PyTorch, summing the
channels in order like the kernel. ``make_delays`` is a torch copy of the
reference's delay table (the same int32 values). The search space, the
problem sizes and the cost-model ``workload()`` are the reference's,
unchanged, so config ids agree across the two packages.

The kernel (its header has the detail): a block owns one block_dm ×
block_t output tile and walks it in sub-tiles of ``group`` dms ×
``sub_t`` samples. Each thread holds G dms × T samples of accumulators
in registers, the T samples 32 apart so a warp reads 32 consecutive
words of shared memory. Channels stream through a ring of ``STAGES``
shared-memory stages filled by ``cp.async``, several channels a stage
and one barrier a stage; each channel stages only the samples its
group's delays reach. Every add reads one word of shared memory, so the
card's shared-memory rate (32 words a clock an SM) bounds it: 0.124 ms
at the hub size, against the 0.031 ms of its float32 adds.

``plan`` turns a tiling into that launch (G, T, warps, channels a stage,
shared memory) on the CPU as on the card, or ``None`` where the kernel
cannot run it; ``fits`` is "``plan`` is not None" and rejects no tiling
of the hub space. ``block_dm`` and ``block_t`` keep the reference's
meaning; ``chan_chunk``, ``delay_layout`` and ``time_unroll`` stay
cost-model-only. Tiles that do not divide (ndm, ntime − MAX_DELAY) are
handled by bounds checks: the output is the reference's (ndm, ntime −
MAX_DELAY), as its pad-then-slice gives, with no padded copy. A delay is
clamped to [0, MAX_DELAY], as the reference's ``dynamic_slice`` clamps
its start.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from .. import cuda
from ..core.costmodel import KernelWorkload, alignment_eff, dma_eff
from ..core.devices import DeviceModel
from ..core.searchspace import SearchSpace
from ..core.tunable import Constraint, tunables_from_dict

ConfigRejected = cuda.ConfigRejected

# Hub problem: 256 channels, 16384 samples, 256 dispersion measures
HUB_NCHAN, HUB_NTIME, HUB_NDM = 256, 16384, 256
BYTES = 4
MAX_DELAY = 512  # delay table values are in [0, MAX_DELAY)

# Recording problem size: small enough that a CPU evaluation of the plain
# version takes milliseconds (the reference's interpret-mode smoke size);
# ntime includes the MAX_DELAY halo the output leaves off
SMOKE_PROBLEM = {"nchan": 32, "ntime": 768 + MAX_DELAY, "ndm": 24}

# limits of csrc/dedispersion.cu (checked against the library when it loads)
STAGES = 4                 # stages of the cp.async ring
MAX_THREADS = 256          # threads a block
MAX_CHANS = 16             # channels a stage
MAX_SMEM_BYTES = 232448    # dynamic shared memory one block may use
MAX_GRID_Y = 65535         # dm tiles per launch
# the kernel's instantiations: dms (G) and samples (T) a thread
DMS_PER_THREAD = (8, 4, 2, 1)
SAMPLES_PER_THREAD = (4, 2)
# how ``plan`` shapes a block
MAX_WARPS_DM = 4           # warps side by side along dm
MAX_SUB_T = 512            # samples of a sub-tile
STAGE_SAMPLES_A_THREAD = 16  # samples a thread stages a stage, halos aside

# kernel launches by ``dedisperse`` (plain-version calls do not count)
launches = 0


def make_delays(nchan: int = HUB_NCHAN, ndm: int = HUB_NDM,
                max_delay: int = MAX_DELAY,
                device: str | torch.device = "cpu") -> torch.Tensor:
    """Quadratic-in-frequency dispersion delays (int32), shape (nchan, ndm):
    the reference's table, computed in float32 in the same order."""
    c = torch.arange(nchan, dtype=torch.float32, device=device)[:, None] / nchan
    d = torch.arange(ndm, dtype=torch.float32, device=device)[None, :] / ndm
    delays = ((max_delay - 1) * d
              * (1.0 / (0.25 + 0.75 * (1 - c)) ** 2 - 1.0) / 15.0)
    return torch.clamp(delays.to(torch.int32), 0, max_delay - 1)


# ----------------------------------------------------------------- kernel
@dataclass(frozen=True)
class Plan:
    """How csrc/dedispersion.cu runs one tiling.

    A thread holds ``dms_per_thread`` (G) × ``samples_per_thread`` (T)
    accumulators; ``warps_dm`` × ``warps_t`` warps make a block, which
    walks its tile in sub-tiles of ``group`` dms × ``sub_t`` samples. Each
    of the ``stages`` ring stages holds ``stage_floats`` floats: up to
    ``chans`` channels of ``sub_t`` samples and one MAX_DELAY halo beside
    them (none where a group is one dm, whose span is ``sub_t``). The
    block takes ``shared_bytes`` of shared memory: the ring, and the
    group's delays and each channel's least delay."""
    dms_per_thread: int
    samples_per_thread: int
    warps_dm: int
    warps_t: int
    chans: int
    stages: int
    stage_floats: int
    shared_bytes: int

    @property
    def threads(self) -> int:
        return 32 * self.warps_dm * self.warps_t

    @property
    def group(self) -> int:
        return self.warps_dm * self.dms_per_thread

    @property
    def sub_t(self) -> int:
        return 32 * self.samples_per_thread * self.warps_t


def _largest_divisor(n: int, cap: int) -> int:
    return max(d for d in range(1, min(n, cap) + 1) if n % d == 0)


def plan(block_dm: int, block_t: int, nchan: int = HUB_NCHAN,
         ndm: int = HUB_NDM) -> Plan | None:
    """The launch plan of one tiling, or None where the kernel cannot run
    it. The rule:

    G is the largest of ``DMS_PER_THREAD`` dividing block_dm; ``warps_dm``
    the largest divisor of block_dm / G up to ``MAX_WARPS_DM``. T is 4
    where block_t is a multiple of 128, else 2; ``warps_t`` the most warps
    (at most ``MAX_THREADS`` a block and ``MAX_SUB_T`` samples a sub-tile)
    whose sub-tiles pad block_t by at most 1/16, so no thread idles but in
    a tile's last sub-tile. ``chans`` = clamp(``STAGE_SAMPLES_A_THREAD`` ×
    threads // sub_t, 2, ``MAX_CHANS``): each thread stages about four
    16-byte pieces a stage, so a wide block on a small grid gets deep
    stages and a one-warp block on a large grid small ones, which leave
    room for more blocks an SM (the rule follows a timing of 2 to 16
    channels a stage at hub tilings on the H100). None when the shared
    memory passes ``MAX_SMEM_BYTES`` (about 6,000 channels at a group of
    8 dms, 1,200 at 32) or the dm tiles pass ``MAX_GRID_Y``."""
    if block_dm < 1 or block_t < 1 or -(-ndm // block_dm) > MAX_GRID_Y:
        return None
    g = next(g for g in DMS_PER_THREAD if block_dm % g == 0)
    warps_dm = _largest_divisor(block_dm // g, MAX_WARPS_DM)
    t = SAMPLES_PER_THREAD[0] if block_t % 128 == 0 else SAMPLES_PER_THREAD[1]
    units = -(-block_t // (32 * t))
    cap = min(MAX_THREADS // 32 // warps_dm, MAX_SUB_T // (32 * t))
    warps_t = max(w for w in range(1, cap + 1)
                  if 16 * (-(-units // w) * w - units) <= units)
    sub_t = 32 * t * warps_t
    threads = 32 * warps_dm * warps_t
    chans = max(2, min(MAX_CHANS, STAGE_SAMPLES_A_THREAD * threads // sub_t))
    group = warps_dm * g
    stage_floats = chans * (sub_t + 4) + (MAX_DELAY if group > 1 else 0)
    shared = 4 * (STAGES * stage_floats + nchan * (group + 1) + 4)
    if shared > MAX_SMEM_BYTES:
        return None
    return Plan(g, t, warps_dm, warps_t, chans, STAGES, stage_floats, shared)


def fits(config: Mapping, problem: Mapping | None = None) -> bool:
    """Whether csrc/dedispersion.cu can run this tiling for ``problem``
    (default: the hub size): its ``plan`` is not None."""
    p = {"nchan": HUB_NCHAN, "ndm": HUB_NDM, **(problem or {})}
    return plan(config["block_dm"], config["block_t"], p["nchan"],
                p["ndm"]) is not None


def _lib() -> ctypes.CDLL:
    lib = cuda.library("dedispersion")
    if lib.repro_dedisperse.argtypes is None:
        limits = [ctypes.c_int() for _ in range(5)]
        lib.repro_dedisperse_limits.argtypes = \
            [ctypes.POINTER(ctypes.c_int)] * 5
        lib.repro_dedisperse_limits.restype = None
        lib.repro_dedisperse_limits(*map(ctypes.byref, limits))
        got = tuple(v.value for v in limits)
        want = (MAX_DELAY, STAGES, MAX_THREADS, MAX_CHANS, MAX_SMEM_BYTES)
        if got != want:
            raise RuntimeError(f"csrc/dedispersion.cu limits {got} disagree "
                               f"with the wrapper's {want}")
        lib.repro_dedisperse.restype = ctypes.c_int
        lib.repro_dedisperse.argtypes = ([ctypes.c_void_p] * 3
                                         + [ctypes.c_int] * 12
                                         + [ctypes.c_void_p])
    return lib


def dedisperse_plain(x: torch.Tensor, delays: torch.Tensor,
                     **_tiling) -> torch.Tensor:
    """The same function in plain PyTorch: for each channel in order, add
    its samples at ``t + delay[c, dm]`` to a float32 (ndm, ntime −
    MAX_DELAY) accumulator."""
    nchan, ntime = x.shape
    ndm = delays.shape[1]
    nt_out = ntime - MAX_DELAY
    t = torch.arange(nt_out, device=x.device)
    d = delays.clamp(0, MAX_DELAY).long()
    xf = x.float()
    acc = torch.zeros((ndm, nt_out), dtype=torch.float32, device=x.device)
    for c in range(nchan):
        acc += xf[c][d[c][:, None] + t[None, :]]
    return acc.to(x.dtype)


def dedisperse(x: torch.Tensor, delays: torch.Tensor, *, block_dm: int = 32,
               block_t: int = 512) -> torch.Tensor:
    """Dedisperse the float32 (nchan, ntime) signal ``x`` (padded with the
    MAX_DELAY halo) with the int32 (nchan, ndm) delay table: output (ndm,
    ntime − MAX_DELAY). The CUDA kernel for tensors on the card,
    ``dedisperse_plain`` for tensors on the CPU. Raises ``ConfigRejected``
    for a tiling ``plan`` refuses, on either device."""
    global launches
    if x.dim() != 2 or delays.dim() != 2 or x.shape[0] != delays.shape[0]:
        raise ValueError(f"dedisperse takes x (nchan, ntime) and delays "
                         f"(nchan, ndm), got {tuple(x.shape)} and "
                         f"{tuple(delays.shape)}")
    nchan, ntime = x.shape
    ndm = delays.shape[1]
    if ntime <= MAX_DELAY or min(nchan, ndm) < 1:
        raise ValueError(f"dedisperse needs ntime > {MAX_DELAY} and at least "
                         f"one channel and dm, got {tuple(x.shape)}, "
                         f"{ndm} dms")
    if x.dtype != torch.float32 or delays.dtype != torch.int32:
        raise ValueError(f"dedisperse takes float32 samples and int32 "
                         f"delays, got {x.dtype} and {delays.dtype}")
    pl = plan(block_dm, block_t, nchan, ndm)
    if pl is None:
        raise ConfigRejected(f"tiling (block_dm {block_dm}, block_t "
                             f"{block_t}) does not fit csrc/dedispersion.cu "
                             f"at {nchan} channels, {ndm} dms")
    if x.device != delays.device:
        raise ValueError("dedisperse operands lie on different devices")
    if x.device.type == "cpu":
        return dedisperse_plain(x, delays)
    if x.device.type != "cuda":
        raise ValueError(f"dedisperse runs on CUDA or the CPU, not "
                         f"{x.device}")
    if not (x.is_contiguous() and delays.is_contiguous()):
        raise ValueError("dedisperse takes contiguous row-major tensors")
    lib = _lib()
    out = torch.empty((ndm, ntime - MAX_DELAY), dtype=torch.float32,
                      device=x.device)
    rc = lib.repro_dedisperse(
        x.data_ptr(), delays.data_ptr(), out.data_ptr(), nchan, ntime, ndm,
        block_dm, block_t, pl.dms_per_thread, pl.samples_per_thread,
        pl.warps_dm, pl.warps_t, pl.chans, pl.stage_floats, pl.shared_bytes,
        cuda.stream_handle(x.device))
    cuda.check_launch(lib, rc, "dedisperse")
    launches += 1
    return out


# ----------------------------------------------------------- live recording
def make_live(problem: Mapping | None = None, device: str | None = None):
    """``fn(config_dict)`` for the recorder: a fixed float32 signal, made
    from ``np.random.default_rng``, and the delay table, on ``device`` (the
    card unless ``"cpu"`` is asked for); on the card ``fn`` waits for the
    launch. The kernel library is built here, before any evaluation. The
    channel-chunk, layout and unroll tunables are cost-model-only."""
    p = {**SMOKE_PROBLEM, **(problem or {})}
    dev = cuda.resolve_device(device)
    on_card = dev != "cpu"
    if on_card:
        _lib()
    x = torch.from_numpy(np.random.default_rng(p.get("seed", 5))
                         .standard_normal((p["nchan"], p["ntime"]),
                                          dtype=np.float32)).to(dev)
    delays = make_delays(p["nchan"], p["ndm"], device=dev)

    def fn(conf: Mapping) -> None:
        dedisperse(x, delays, block_dm=conf["block_dm"],
                   block_t=conf["block_t"])
        if on_card:
            torch.cuda.synchronize(dev)

    return fn


# ------------------------------------------------------------ search space
def space(nchan: int = HUB_NCHAN, ntime: int = HUB_NTIME,
          ndm: int = HUB_NDM) -> SearchSpace:
    nt_out = ntime - MAX_DELAY
    tunables = tunables_from_dict({
        "block_dm": (1, 2, 4, 8, 12, 16, 24, 32, 48, 64, 96, 128),
        "block_t": (128, 192, 256, 384, 512, 768, 1024, 1536, 2048, 3968),
        "chan_chunk": (8, 16, 32, 64, 128, 256),
        "delay_layout": ("dm_major", "chan_major"),
        "time_unroll": (1, 2, 4),
    })
    constraints = (
        Constraint(lambda c: nchan % c["chan_chunk"] == 0,
                   "chan_chunk divides channels"),
    )
    return SearchSpace(tunables, constraints, name="dedispersion")


# -------------------------------------------------------------- cost model
def workload(nchan: int = HUB_NCHAN, ntime: int = HUB_NTIME,
             ndm: int = HUB_NDM) -> KernelWorkload:
    nt_out = ntime - MAX_DELAY

    def _padded(c: Mapping):
        bdm, bt = c["block_dm"], c["block_t"]
        return (-(-ndm // bdm) * bdm, -(-nt_out // bt) * bt)

    def flops(c: Mapping) -> float:
        ndm_p, nt_p = _padded(c)
        return 1.0 * nchan * ndm_p * nt_p  # adds only

    def hbm_bytes(c: Mapping, dev: DeviceModel) -> float:
        bt = c["block_t"]
        ndm_p, nt_p = _padded(c)
        # channel block re-read per dm-tile; halo MAX_DELAY per time tile
        n_dm_tiles = ndm_p // c["block_dm"]
        x_blk = nchan * (bt + MAX_DELAY) * BYTES
        x_reads = (nchan * (bt + MAX_DELAY) * BYTES * n_dm_tiles
                   * (nt_p // bt) / dma_eff(x_blk))
        out_write = ndm_p * nt_p * BYTES / dma_eff(
            c["block_dm"] * c["block_t"] * BYTES)
        delay_reads = nchan * ndm_p * 4
        return x_reads + out_write + delay_reads

    def vmem_bytes(c: Mapping) -> float:
        bdm, bt = c["block_dm"], c["block_t"]
        x_blk = nchan * (bt + MAX_DELAY) * BYTES
        return 2 * (x_blk + nchan * bdm * 4) + bdm * bt * (4 + BYTES)

    def grid_size(c: Mapping) -> float:
        ndm_p, nt_p = _padded(c)
        return (ndm_p // c["block_dm"]) * (nt_p // c["block_t"])

    def compute_eff(c: Mapping, dev: DeviceModel) -> float:
        eff = (alignment_eff(c["block_dm"], dev.sublane)
               * alignment_eff(c["block_t"], dev.lane))
        eff *= 0.08  # gather-bound VPU kernel
        # larger chan chunks amortize loop control until VREG pressure bites
        eff *= {8: 0.8, 16: 0.9, 32: 1.0, 64: 1.0, 128: 0.93, 256: 0.85}[
            c["chan_chunk"]]
        if c["delay_layout"] == "chan_major":
            eff *= 0.97
        eff *= {1: 0.95, 2: 1.0, 4: 0.98}[c["time_unroll"]]
        return eff

    return KernelWorkload("dedispersion", flops, hbm_bytes, vmem_bytes,
                          grid_size, compute_eff)

"""Dedispersion — radio-astronomy signal reconstruction (benchmark-hub kernel).

Port of ``src/repro/kernels/dedispersion.py``: out[dm, t] = Σ_c x[c, t +
delay[c, dm]], a gather-reduce over the channels. The Pallas TPU kernel
``_dedisp_kernel``/``dedisperse`` becomes the hand-written CUDA kernel
``csrc/dedispersion.cu`` (its header says what bounds it on the H100 and
how a tile larger than shared memory and registers is walked);
``dedisperse`` here is its wrapper and ``dedisperse_plain`` the same
function in plain PyTorch, summing the channels in order like the
kernel. ``make_delays`` is a torch copy of the reference's delay table
(the same int32 values). The search space, the problem sizes and the
cost-model ``workload()`` are the reference's, unchanged, so config ids
agree across the two packages.

``block_dm`` and ``block_t`` reach the kernel as runtime arguments;
``chan_chunk``, ``delay_layout`` and ``time_unroll`` stay cost-model-only.
Tiles that do not divide (ndm, ntime − MAX_DELAY) are handled by bounds
checks: the output is the reference's (ndm, ntime − MAX_DELAY), as its
pad-then-slice gives, with no padded copy. A delay is clamped to
[0, MAX_DELAY], as the reference's ``dynamic_slice`` clamps its start.
"""
from __future__ import annotations

import ctypes
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
GROUP_DM = 16              # dm accumulators a thread
SEG = 256 + MAX_DELAY      # staged samples of one channel
MAX_SMEM_BYTES = 232448    # dynamic shared memory one block may use
MAX_GRID_Y = 65535         # dm tiles per launch

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
def fits(config: Mapping, problem: Mapping | None = None) -> bool:
    """Whether csrc/dedispersion.cu can run this tiling for ``problem``
    (default: the hub size): the double-buffered channel segment and one
    dm group's delays of every channel within one block's shared memory,
    and at most ``MAX_GRID_Y`` dm tiles. Any block_dm × block_t tile runs:
    the block walks it in sub-tiles."""
    p = {"nchan": HUB_NCHAN, "ndm": HUB_NDM, **(problem or {})}
    smem = (2 * SEG + p["nchan"] * GROUP_DM) * 4
    return (config["block_dm"] >= 1 and config["block_t"] >= 1
            and smem <= MAX_SMEM_BYTES
            and -(-p["ndm"] // config["block_dm"]) <= MAX_GRID_Y)


def _lib() -> ctypes.CDLL:
    lib = cuda.library("dedispersion")
    if lib.repro_dedisperse.argtypes is None:
        limits = [ctypes.c_int() for _ in range(4)]
        lib.repro_dedisperse_limits.argtypes = \
            [ctypes.POINTER(ctypes.c_int)] * 4
        lib.repro_dedisperse_limits.restype = None
        lib.repro_dedisperse_limits(*map(ctypes.byref, limits))
        got = tuple(v.value for v in limits)
        want = (MAX_DELAY, GROUP_DM, SEG, MAX_SMEM_BYTES)
        if got != want:
            raise RuntimeError(f"csrc/dedispersion.cu limits {got} disagree "
                               f"with the wrapper's {want}")
        lib.repro_dedisperse.restype = ctypes.c_int
        lib.repro_dedisperse.argtypes = ([ctypes.c_void_p] * 3
                                         + [ctypes.c_int] * 5
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
    for a tiling ``fits`` refuses, on either device."""
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
    conf = {"block_dm": block_dm, "block_t": block_t}
    if not fits(conf, {"nchan": nchan, "ndm": ndm}):
        raise ConfigRejected(f"tiling {conf} does not fit "
                             f"csrc/dedispersion.cu at {nchan} channels, "
                             f"{ndm} dms")
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
    rc = lib.repro_dedisperse(x.data_ptr(), delays.data_ptr(),
                              out.data_ptr(), nchan, ntime, ndm, block_dm,
                              block_t, cuda.stream_handle(x.device))
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

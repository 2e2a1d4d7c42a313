"""Hotspot — thermal simulation stencil (benchmark-hub kernel, Rodinia).

Port of ``src/repro/kernels/hotspot.py``. The Pallas TPU kernel
``_hotspot_kernel``/``hotspot`` becomes the hand-written CUDA kernel
``csrc/hotspot.cu``: ghost-zone temporal blocking of ``t_block`` steps per
launch, its pyramid's intermediate planes in a per-block global scratch
buffer (a halo'd tile of the hub space does not fit shared memory; the
source's header says what bounds it on the H100). ``hotspot`` here is its
wrapper and ``hotspot_plain`` the same function in plain PyTorch:
``t_block`` wrap-padded steps, like the reference's ``hotspot_ref``. The
search space, the problem sizes and the cost-model ``workload()`` are the
reference's, unchanged, so config ids agree across the two packages.

``strip_h``, ``block_w`` and ``t_block`` reach the kernel as runtime
arguments; ``io_dtype``, ``acc_dtype`` and ``grid_order`` stay
cost-model-only. Periodic boundaries are index arithmetic in the kernel,
not a padded copy. The kernel does every step in the order of the
reference's ``_stencil_once``, with explicit round-to-nearest operations
(no FMA contraction), so on the card it equals ``hotspot_plain`` bit for
bit.

The live objective is the reference's: one launch of ``t_block`` steps,
while ``workload()`` models ``HUB_STEPS`` = 16 steps. A live recording so
ranks small ``t_block`` fastest by construction; the port keeps it for
parity with the reference (ROADMAP Queue 3 lists the fault for both).
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

HUB_H, HUB_W = 4096, 4096
HUB_STEPS = 16           # timesteps per hub measurement
BYTES = 4                # fp32 grids

# Recording problem size: small enough that a CPU evaluation of the plain
# version takes milliseconds (the reference's interpret-mode smoke size)
SMOKE_PROBLEM = {"h": 64, "w": 128}
# physical coefficients (Rodinia-style, folded constants)
C_CENTER, C_NEIGH, C_POWER = 0.6, 0.1, 0.5

# kernel launches by ``hotspot`` (plain-version calls on the CPU do not count)
launches = 0


def _stencil_once(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """One step on an (r, c) block; returns the (r-2, c-2) interior."""
    interior = t[1:-1, 1:-1]
    neigh = (t[:-2, 1:-1] + t[2:, 1:-1] + t[1:-1, :-2] + t[1:-1, 2:])
    return (C_CENTER * interior + C_NEIGH * neigh
            + C_POWER * p[1:-1, 1:-1])


def _wrap1(a: torch.Tensor) -> torch.Tensor:
    """``a`` padded by one cell a side with periodic boundaries."""
    a = torch.cat([a[-1:], a, a[:1]], dim=0)
    return torch.cat([a[:, -1:], a, a[:, :1]], dim=1)


# ----------------------------------------------------------------- kernel
def fits(config: Mapping, problem: Mapping | None = None) -> bool:
    """Whether csrc/hotspot.cu can run this tiling for ``problem`` (default:
    the hub size): tiles that divide the grid (the reference asserts the
    same) and a halo, ``t_block``, under the grid's smaller side (one wrap
    of the periodic boundary). Every tiling of the hub space runs: the
    pyramid lives in global scratch, not in one block's shared memory."""
    p = {"h": HUB_H, "w": HUB_W, **(problem or {})}
    sh, bw, tb = config["strip_h"], config["block_w"], config["t_block"]
    return (sh >= 1 and bw >= 1 and p["h"] % sh == 0 and p["w"] % bw == 0
            and 1 <= tb < min(p["h"], p["w"]))


def _lib() -> ctypes.CDLL:
    lib = cuda.library("hotspot")
    if lib.repro_hotspot.argtypes is None:
        lib.repro_hotspot_slots.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.repro_hotspot_slots.restype = ctypes.c_int
        lib.repro_hotspot.restype = ctypes.c_int
        lib.repro_hotspot.argtypes = ([ctypes.c_void_p] * 4
                                      + [ctypes.c_int] * 6
                                      + [ctypes.c_void_p])
    return lib


def _slots(lib: ctypes.CDLL) -> int:
    """Blocks of the kernel the card keeps resident at once."""
    slots = ctypes.c_int()
    cuda.check_launch(lib, lib.repro_hotspot_slots(ctypes.byref(slots)),
                      "hotspot occupancy query")
    return slots.value


def hotspot_plain(temp: torch.Tensor, power: torch.Tensor, *,
                  t_block: int = 1, **_tiling) -> torch.Tensor:
    """The same function in plain PyTorch (the reference's
    ``hotspot_ref``): ``t_block`` stencil steps, each on the grid padded by
    one cell with periodic boundaries."""
    t = temp.float()
    pp = _wrap1(power.float())
    for _ in range(t_block):
        t = _stencil_once(_wrap1(t), pp)
    return t.to(temp.dtype)


def hotspot(temp: torch.Tensor, power: torch.Tensor, *, strip_h: int = 64,
            block_w: int = 256, t_block: int = 1) -> torch.Tensor:
    """Advance the (H, W) float32 thermal grid ``temp`` under ``power`` by
    ``t_block`` fused steps with periodic boundaries: the CUDA kernel for
    tensors on the card, ``hotspot_plain`` for tensors on the CPU. Raises
    ``ConfigRejected`` for a tiling ``fits`` refuses, on either device."""
    global launches
    if temp.dim() != 2 or temp.shape != power.shape:
        raise ValueError(f"hotspot takes two 2-D grids of one shape, got "
                         f"{tuple(temp.shape)} and {tuple(power.shape)}")
    if temp.dtype != torch.float32 or power.dtype != torch.float32:
        raise ValueError(f"hotspot takes float32 grids, got {temp.dtype} "
                         f"and {power.dtype}")
    h, w = temp.shape
    conf = {"strip_h": strip_h, "block_w": block_w, "t_block": t_block}
    if not fits(conf, {"h": h, "w": w}):
        raise ConfigRejected(f"tiling {conf} does not fit csrc/hotspot.cu "
                             f"on a {h}x{w} grid")
    if temp.device != power.device:
        raise ValueError("hotspot operands lie on different devices")
    if temp.device.type == "cpu":
        return hotspot_plain(temp, power, t_block=t_block)
    if temp.device.type != "cuda":
        raise ValueError(f"hotspot runs on CUDA or the CPU, not "
                         f"{temp.device}")
    if not (temp.is_contiguous() and power.is_contiguous()):
        raise ValueError("hotspot takes contiguous row-major grids")
    lib = _lib()
    grid = min((h // strip_h) * (w // block_w), _slots(lib))
    out = torch.empty((h, w), dtype=torch.float32, device=temp.device)
    scratch = None
    if t_block > 1:
        plane = (strip_h + 2 * t_block) * (block_w + 2 * t_block)
        scratch = torch.empty(grid * 2 * plane, dtype=torch.float32,
                              device=temp.device)
    rc = lib.repro_hotspot(temp.data_ptr(), power.data_ptr(), out.data_ptr(),
                           None if scratch is None else scratch.data_ptr(),
                           h, w, strip_h, block_w, t_block, grid,
                           cuda.stream_handle(temp.device))
    cuda.check_launch(lib, rc, "hotspot")
    launches += 1
    return out


# ----------------------------------------------------------- live recording
def make_live(problem: Mapping | None = None, device: str | None = None):
    """``fn(config_dict)`` for the recorder: ``t_block`` fused stencil
    steps on a fixed float32 grid on ``device`` (the card unless ``"cpu"``
    is asked for), made from ``np.random.default_rng``; on the card ``fn``
    waits for the launch. The kernel library is built here, before any
    evaluation. Constraints bound to the problem size (divisibility,
    pyramid halo) are enforced by ``space(h, w)``; the dtype and grid-order
    tunables are cost-model-only."""
    p = {**SMOKE_PROBLEM, **(problem or {})}
    dev = cuda.resolve_device(device)
    on_card = dev != "cpu"
    if on_card:
        _lib()
    seed = p.get("seed", 3)
    t = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (p["h"], p["w"]), dtype=np.float32)).to(dev)
    pw = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (p["h"], p["w"]), dtype=np.float32) * np.float32(0.1)).to(dev)

    def fn(conf: Mapping) -> None:
        hotspot(t, pw, strip_h=conf["strip_h"], block_w=conf["block_w"],
                t_block=conf["t_block"])
        if on_card:
            torch.cuda.synchronize(dev)

    return fn


# ------------------------------------------------------------ search space
def space(h: int = HUB_H, w: int = HUB_W) -> SearchSpace:
    tunables = tunables_from_dict({
        "strip_h": (8, 16, 32, 64, 128, 256, 512, 1024),
        "block_w": (128, 256, 512, 1024, 2048, 4096),
        "io_dtype": ("f32", "bf16"),
        "t_block": tuple(range(1, 17)),
        "acc_dtype": ("f32", "bf16"),
        "grid_order": ("row", "col"),
    })
    constraints = (
        Constraint(lambda c: h % c["strip_h"] == 0, "strip_h divides H"),
        Constraint(lambda c: w % c["block_w"] == 0, "block_w divides W"),
        Constraint(lambda c: 2 * c["t_block"] < c["strip_h"],
                   "pyramid halo must fit the strip"),
    )
    return SearchSpace(tunables, constraints, name="hotspot")


# -------------------------------------------------------------- cost model
def workload(h: int = HUB_H, w: int = HUB_W,
             steps: int = HUB_STEPS) -> KernelWorkload:
    def flops(c: Mapping) -> float:
        tb, sh, bw = c["t_block"], c["strip_h"], c["block_w"]
        # redundant pyramid compute: each fused step s processes
        # (sh + 2(tb-s))×(bw + 2(tb-s)) instead of sh×bw
        per_tile = sum((sh + 2 * (tb - s)) * (bw + 2 * (tb - s))
                       for s in range(1, tb + 1))
        n_tiles = (h // sh) * (w // bw)
        launches = -(-steps // tb)
        return 8.0 * per_tile * n_tiles * launches

    def hbm_bytes(c: Mapping, dev: DeviceModel) -> float:
        tb, sh, bw = c["t_block"], c["strip_h"], c["block_w"]
        halo_factor = ((sh + 2 * tb) / sh) * ((bw + 2 * tb) / bw)
        blk = (sh + 2 * tb) * (bw + 2 * tb) * BYTES
        byt = BYTES if c["io_dtype"] == "f32" else 2
        per_launch = (h * w * byt * 2 * halo_factor / dma_eff(blk)
                      + h * w * byt / dma_eff(sh * bw * byt))
        return per_launch * -(-steps // tb)

    def vmem_bytes(c: Mapping) -> float:
        tb, sh, bw = c["t_block"], c["strip_h"], c["block_w"]
        blk = (sh + 2 * tb) * (bw + 2 * tb) * BYTES
        return 2 * (2 * blk + sh * bw * BYTES) + blk  # T,P in, out, scratch

    def grid_size(c: Mapping) -> float:
        return ((h // c["strip_h"]) * (w // c["block_w"])
                * -(-steps // c["t_block"]))

    def compute_eff(c: Mapping, dev: DeviceModel) -> float:
        eff = (alignment_eff(c["strip_h"], dev.sublane)
               * alignment_eff(c["block_w"], dev.lane))
        eff *= 0.11  # VPU-bound stencil
        if c["acc_dtype"] == "bf16":
            eff *= 1.05
        if c["io_dtype"] == "bf16":
            eff *= 0.97  # conversion cost (but traffic halves)
        if c["grid_order"] == "col":
            eff *= 0.95
        return eff

    return KernelWorkload("hotspot", flops, hbm_bytes, vmem_bytes, grid_size,
                          compute_eff)

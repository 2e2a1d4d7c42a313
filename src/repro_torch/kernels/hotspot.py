"""Hotspot — thermal simulation stencil (benchmark-hub kernel, Rodinia).

Port of ``src/repro/kernels/hotspot.py``. The Pallas TPU kernel
``_hotspot_kernel``/``hotspot`` becomes the hand-written CUDA kernel
``csrc/hotspot.cu`` (its header says what bounds it on the H100):
ghost-zone temporal blocking of ``t_block`` steps per launch, with the
whole pyramid on chip. A block owns one strip_h × block_w tile and walks
it in sub-tiles; each halo'd sub-tile is read from device memory once, a
thread keeps T and P of a vertical run of ``ROWS`` cells in registers, and
each step trades the run's T with its neighbours through a shared-memory
plane. ``hotspot`` here is its wrapper and ``hotspot_plain`` the same
function in plain PyTorch: ``t_block`` wrap-padded steps, like the
reference's ``hotspot_ref``. The search space, the problem sizes and the
cost-model ``workload()`` are the reference's, unchanged, so config ids
agree across the two packages.

``plan`` turns a tiling into that launch (threads, sub-tile, plane pitch,
shared memory) on the CPU as on the card, and refuses no tiling of the hub
space. ``strip_h``, ``block_w`` and ``t_block`` keep the reference's
meaning; ``io_dtype``, ``acc_dtype`` and ``grid_order`` stay
cost-model-only. Periodic boundaries are index arithmetic in the kernel,
not a padded copy. The kernel does every step in the order of the
reference's ``_stencil_once``, with explicit round-to-nearest operations
(no FMA contraction), so on the card it equals ``hotspot_plain`` bit for
bit. More than ``MAX_STEPS`` fused steps (none of the hub space's) run as
several launches of at most ``MAX_STEPS`` each.

The live objective is the reference's: one launch of ``t_block`` steps,
while ``workload()`` models ``HUB_STEPS`` = 16 steps. A live recording so
ranks small ``t_block`` fastest by construction; the port keeps it for
parity with the reference (ROADMAP Queue 3 lists the fault for both).
"""
from __future__ import annotations

import ctypes
import functools
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

HUB_H, HUB_W = 4096, 4096
HUB_STEPS = 16           # timesteps per hub measurement
BYTES = 4                # fp32 grids

# Recording problem size: small enough that a CPU evaluation of the plain
# version takes milliseconds (the reference's interpret-mode smoke size)
SMOKE_PROBLEM = {"h": 64, "w": 128}
# physical coefficients (Rodinia-style, folded constants)
C_CENTER, C_NEIGH, C_POWER = 0.6, 0.1, 0.5

# limits of csrc/hotspot.cu (checked against the library when it loads)
MAX_THREADS = 512        # threads a block
MAX_STEPS = 16           # fused steps a launch
MAX_SMEM_BYTES = 65536   # two planes of MAX_THREADS * ROWS floats
ROWS = 16                # R: cells of one column a thread holds
WARP = 32                # a block's rows of threads are whole warps

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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ----------------------------------------------------------------- kernel
@dataclass(frozen=True)
class Plan:
    """How csrc/hotspot.cu runs one tiling for ``t_block`` fused steps.

    ``threads_x`` x ``threads_y`` threads make a block; thread (x, y) owns
    column x, rows y·``rows`` .. y·``rows`` + ``rows`` - 1 of the halo'd
    sub-tile, (``sub_h`` + 2t) x (``sub_w`` + 2t) cells around ``sub_h`` x
    ``sub_w`` outputs. Each step's T goes to one of two shared-memory
    planes of threads_y·rows rows of ``pitch`` floats (a warp reads and
    writes 32 adjacent words of one row, so any pitch is free of bank
    conflicts and the pitch is threads_x); ``shared_bytes`` is both."""
    t_block: int
    rows: int
    threads_x: int
    threads_y: int
    sub_h: int
    sub_w: int
    pitch: int
    shared_bytes: int

    @property
    def threads(self) -> int:
        return self.threads_x * self.threads_y

    @property
    def instantiation(self) -> str:
        return f"hotspot_kernel<R {self.rows}>"

    def sub_tiles(self, strip_h: int, block_w: int) -> int:
        """Sub-tiles of one whole strip_h x block_w tile."""
        return _cdiv(strip_h, self.sub_h) * _cdiv(block_w, self.sub_w)

    def _steps(self):
        """Per step s: the rows of the halo'd sub-tile it updates, and for
        each run of ``rows`` those of its rows it updates."""
        t, r = self.t_block, self.rows
        hh = self.sub_h + 2 * t
        for s in range(1, t + 1):
            yield s, [max(0, min(hh - s, r * (j + 1)) - max(s, r * j))
                      for j in range(self.threads_y)]

    def cost(self, strip_h: int, block_w: int) -> int:
        """What ``plan`` minimises, in warp-rows a tile: a warp's load of
        a row of T and P, a row of cells it updates in one step, and the
        barrier and bookkeeping of its step count one each. A warp skips
        rows and steps in which none of its 32 columns is in the pyramid."""
        hw = self.sub_w + 2 * self.t_block
        warps_x = self.threads_x // WARP
        units = (self.sub_h + 2 * self.t_block) * warps_x
        for s, runs in self._steps():
            cols = sum(max(WARP * k, s) < min(WARP * (k + 1), hw - s)
                       for k in range(warps_x))
            units += sum(runs) * cols + self.threads_y * warps_x
        return units * self.sub_tiles(strip_h, block_w)

    def work(self, strip_h: int, block_w: int) -> tuple:
        """``(cell-steps, shared-memory words)`` of one tile: the pyramid's
        cells updated over the t_block steps of every sub-tile, and the
        words its steps move through shared memory (every thread stores
        its run each step; an updated cell loads left and right, and each
        run with an updated cell loads the cells above and below it)."""
        hw = self.sub_w + 2 * self.t_block
        cells = words = 0
        for s, runs in self._steps():
            cols = max(0, hw - 2 * s)
            cells += sum(runs) * cols
            words += (self.threads * self.rows
                      + 2 * (sum(runs) + sum(map(bool, runs))) * cols)
        n = self.sub_tiles(strip_h, block_w)
        return cells * n, words * n


@functools.lru_cache(maxsize=None)
def plan(strip_h: int, block_w: int, t_block: int) -> Plan | None:
    """The launch plan of one tiling, or None where the kernel cannot run
    it (a tile side below 1, t_block outside 1..``MAX_STEPS``). The rule:

    For each width of at most ``MAX_THREADS`` threads, in whole warps: the
    fewest column sub-tiles whose halo'd width it holds, evened out (so
    sub_w is ceil(block_w / n)), the warps that cover sub_w + 2 t_block,
    and under them as many runs of ``ROWS`` as ``MAX_THREADS`` allows:
    the fewest row sub-tiles whose halo'd height those hold, evened out,
    and the runs that cover sub_h + 2 t_block. Of these candidates the
    one of least ``Plan.cost`` wins; ties go to fewer sub-tiles, then more
    threads. Every tile of sides at least 1 gets a plan for every
    t_block up to ``MAX_STEPS``."""
    t = t_block
    if not (strip_h >= 1 and block_w >= 1 and 1 <= t <= MAX_STEPS):
        return None
    best = None
    for cap in range(WARP, MAX_THREADS + 1, WARP):
        if cap <= 2 * t:
            continue
        sub_w = _cdiv(block_w, _cdiv(block_w, cap - 2 * t))
        tx = WARP * _cdiv(sub_w + 2 * t, WARP)
        room = ROWS * (MAX_THREADS // tx) - 2 * t
        if room < 1:
            continue
        sub_h = _cdiv(strip_h, _cdiv(strip_h, room))
        ty = _cdiv(sub_h + 2 * t, ROWS)
        cand = Plan(t, ROWS, tx, ty, sub_h, sub_w, tx,
                    2 * ty * ROWS * tx * 4)
        key = (cand.cost(strip_h, block_w),
               cand.sub_tiles(strip_h, block_w), -cand.threads)
        if best is None or key < best[0]:
            best = (key, cand)
    return None if best is None else best[1]


def _launch_steps(t_block: int) -> list:
    """The fused steps of each launch that runs ``t_block`` steps: one
    launch up to ``MAX_STEPS``, else launches of ``MAX_STEPS`` and the
    rest."""
    full, rest = divmod(t_block, MAX_STEPS)
    return [MAX_STEPS] * full + ([rest] if rest else [])


def fits(config: Mapping, problem: Mapping | None = None) -> bool:
    """Whether csrc/hotspot.cu can run this tiling for ``problem`` (default:
    the hub size): tiles that divide the grid (the reference asserts the
    same) and a halo, ``t_block``, under the grid's smaller side (one wrap
    of the periodic boundary). Every tiling of the hub space runs: a block
    walks a tile too large for it in sub-tiles (``plan``), and more than
    ``MAX_STEPS`` fused steps run as several launches."""
    p = {"h": HUB_H, "w": HUB_W, **(problem or {})}
    sh, bw, tb = config["strip_h"], config["block_w"], config["t_block"]
    return (sh >= 1 and bw >= 1 and p["h"] % sh == 0 and p["w"] % bw == 0
            and 1 <= tb < min(p["h"], p["w"]))


def _lib() -> ctypes.CDLL:
    lib = cuda.library("hotspot")
    if lib.repro_hotspot.argtypes is None:
        limits = [ctypes.c_int() for _ in range(4)]
        lib.repro_hotspot_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
        lib.repro_hotspot_limits.restype = None
        lib.repro_hotspot_limits(*map(ctypes.byref, limits))
        got = tuple(v.value for v in limits)
        want = (MAX_THREADS, MAX_STEPS, MAX_SMEM_BYTES, ROWS)
        if got != want:
            raise RuntimeError(f"csrc/hotspot.cu limits {got} disagree with "
                               f"the wrapper's {want}")
        lib.repro_hotspot.restype = ctypes.c_int
        lib.repro_hotspot.argtypes = ([ctypes.c_void_p] * 3
                                      + [ctypes.c_int] * 12
                                      + [ctypes.c_void_p])
    return lib


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
    ``ConfigRejected`` for a tiling ``fits`` or ``plan`` refuses, on either
    device."""
    global launches
    if temp.dim() != 2 or temp.shape != power.shape:
        raise ValueError(f"hotspot takes two 2-D grids of one shape, got "
                         f"{tuple(temp.shape)} and {tuple(power.shape)}")
    if temp.dtype != torch.float32 or power.dtype != torch.float32:
        raise ValueError(f"hotspot takes float32 grids, got {temp.dtype} "
                         f"and {power.dtype}")
    h, w = temp.shape
    conf = {"strip_h": strip_h, "block_w": block_w, "t_block": t_block}
    plans = ([plan(strip_h, block_w, s) for s in _launch_steps(t_block)]
             if fits(conf, {"h": h, "w": w}) else [None])
    if None in plans:
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
    out = temp
    for pl in plans:
        src, out = out, torch.empty((h, w), dtype=torch.float32,
                                    device=temp.device)
        rc = lib.repro_hotspot(src.data_ptr(), power.data_ptr(),
                               out.data_ptr(), h, w, strip_h, block_w,
                               pl.t_block, pl.rows, pl.threads_x,
                               pl.threads_y, pl.sub_h, pl.sub_w, pl.pitch,
                               pl.shared_bytes,
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

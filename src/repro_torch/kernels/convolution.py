"""2-D convolution stencil (benchmark-hub kernel; image filtering).

Port of ``src/repro/kernels/convolution.py``. The Pallas TPU kernel
``_conv_kernel``/``conv2d`` becomes the hand-written CUDA kernel
``csrc/convolution.cu`` (its header says what bounds it on the H100 and how
a tile larger than shared memory is walked); ``conv2d`` here is its wrapper
and ``conv2d_plain`` the same function in plain PyTorch: the dy-outer,
dx-inner shifted multiply-adds of the reference's ``conv2d_ref``. The search
space, the problem sizes and the cost-model ``workload()`` are the
reference's, unchanged: the same tunables in the same order, so config ids
agree across the two packages.

The kernel (its header has the detail): a block owns one strip_h ×
block_w output tile and walks it in sub-tiles. Each thread holds R rows ×
C adjacent columns of outputs in registers; per filter row it holds that
row of the filter in registers and reads each of its R input rows once,
as float4s, so the float32 pipe and not shared memory sets its pace. The
sub-tiles' halo'd input streams into a ring of shared-memory stages
filled by ``cp.async``, zeros outside the image included.

``plan`` turns a tiling and filter into that launch (instantiation, R,
C, threads, stages, shared memory) on the CPU as on the card; ``fits``
is "``plan`` is not None and the row tiles fit one launch" and rejects no
tiling of the hub space. ``strip_h`` and ``block_w`` keep the reference's
meaning. Tiles the image does not divide are handled by bounds checks,
with the same result as the reference's zero padding. ``unroll_fh``,
``acc_dtype`` and ``vector_w`` stay cost-model-only, as in the
reference's ``make_live``. A problem the kernel cannot run (a filter
wider than 33 taps, or more row tiles than one launch takes) raises
``ConfigRejected`` before any launch, on the CPU as on the card.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from .. import cuda
from ..core.costmodel import KernelWorkload, alignment_eff, dma_eff
from ..core.devices import DeviceModel
from ..core.searchspace import SearchSpace
from ..core.tunable import Constraint, tunables_from_dict

ConfigRejected = cuda.ConfigRejected

# Hub problem: 4096×4096 image, 17×17 filter (Kernel Tuner's conv benchmark)
HUB_H, HUB_W, HUB_FH, HUB_FW = 4096, 4096, 17, 17
BYTES = 4  # fp32 image

# Recording problem size: small enough that a CPU evaluation of the plain
# version takes milliseconds (the reference's interpret-mode smoke size)
SMOKE_PROBLEM = {"h": 128, "w": 256, "fh": 7, "fw": 7}

# limits of csrc/convolution.cu (checked against the library when it loads)
MAX_FILTER = 33            # filter taps a side
MAX_THREADS = 512          # threads a block
MAX_STAGES = 3             # stages of the cp.async ring
MAX_SMEM_BYTES = 232448    # dynamic shared memory one block may use
COLS_PER_THREAD = 4        # adjacent output columns a thread holds (C)
MAX_GRID_Y = 65535         # row tiles per launch
# the kernel's instantiations: filter width (0: any width up to MAX_FILTER,
# read at run time) -> output rows a thread holds (R)
INSTANTIATIONS = {3: 8, 5: 8, 7: 8, 17: 8, 0: 4}
# how ``plan`` shapes a block
MAX_THREADS_X = 128        # threads side by side along a row
BIG_TILE = 65536           # outputs from which a block takes MAX_THREADS
SMALL_THREADS = 256        # threads a block below BIG_TILE

# kernel launches by ``conv2d`` (plain-version calls on the CPU do not count)
launches = 0


# ----------------------------------------------------------------- kernel
@dataclass(frozen=True)
class Plan:
    """How csrc/convolution.cu runs one tiling.

    ``filter_width`` names the instantiation: a width the kernel unrolls,
    or 0 for the one that reads the width at run time. A thread holds
    ``rows`` (R) x ``cols`` (C) outputs; ``threads_x`` x ``threads_y``
    threads make a block, which walks its strip_h x block_w tile in
    sub-tiles of ``sub_h`` x ``sub_w`` outputs. Each sub-tile's halo'd
    input, ``sub_h + fh - 1`` rows of ``pitch`` floats, streams into one of
    ``stages`` ring stages; the filter, its rows padded to 4 floats, sits
    after the ring. ``shared_bytes`` is all of it."""
    filter_width: int
    rows: int
    cols: int
    threads_x: int
    threads_y: int
    stages: int
    pitch: int
    shared_bytes: int

    @property
    def threads(self) -> int:
        return self.threads_x * self.threads_y

    @property
    def sub_h(self) -> int:
        return self.threads_y * self.rows

    @property
    def sub_w(self) -> int:
        return self.threads_x * self.cols

    @property
    def instantiation(self) -> str:
        fw = self.filter_width or "runtime"
        return f"conv2d_kernel<fw {fw}, R {self.rows}>"

    def sub_tiles(self, strip_h: int, block_w: int) -> int:
        """Sub-tiles of one whole strip_h x block_w tile."""
        return -(-strip_h // self.sub_h) * -(-block_w // self.sub_w)


def plan(strip_h: int, block_w: int, fh: int = HUB_FH,
         fw: int = HUB_FW) -> Plan | None:
    """The launch plan of one tiling, or None where the kernel cannot run
    it (a filter side outside 1..``MAX_FILTER``, a tile side below 1). The
    rule:

    The instantiation is the filter width where the kernel unrolls it
    (``INSTANTIATIONS``), else the run-time one (0); it fixes R, and C is
    ``COLS_PER_THREAD``. A block takes ``MAX_THREADS`` threads where its
    tile holds at least ``BIG_TILE`` outputs (large tiles make small
    grids), else ``SMALL_THREADS``. Along a row: the fewest passes of at
    most ``MAX_THREADS_X`` threads that cover block_w / C, each pass's
    threads rounded up to 8 (so a quarter-warp's float4 reads stay in one
    row). Down the tile: the fewest passes of the remaining threads that
    cover strip_h / R, evened out. Three ring stages where the tile has
    three sub-tiles and they fit, else two; where two do not fit (a tall
    filter under a wide block), the sub-tile's rows are halved until they
    do. Every tile and filter within the limits gets a plan."""
    if not (1 <= fh <= MAX_FILTER and 1 <= fw <= MAX_FILTER
            and strip_h >= 1 and block_w >= 1):
        return None
    inst = fw if fw in INSTANTIATIONS else 0
    r, c = INSTANTIATIONS[inst], COLS_PER_THREAD
    cap = MAX_THREADS if strip_h * block_w >= BIG_TILE else SMALL_THREADS
    units_x, units_y = -(-block_w // c), -(-strip_h // r)
    passes_x = -(-units_x // MAX_THREADS_X)
    tx = 8 * -(-units_x // (8 * passes_x))
    passes_y = -(-units_y // max(1, cap // tx))
    ty = -(-units_y // passes_y)
    # a thread's window: C + fw - 1 floats read as whole float4s
    pitch = c * (tx - 1) + 4 * -(-(c + fw - 1) // 4)
    filter_floats = fh * 4 * -(-fw // 4)

    def shared(stages: int, ty: int) -> int:
        return 4 * (stages * (ty * r + fh - 1) * pitch + filter_floats)

    while ty > 1 and shared(2, ty) > MAX_SMEM_BYTES:  # a tall filter
        ty = -(-ty // 2)
    n_sub = -(-strip_h // (ty * r)) * -(-block_w // (tx * c))
    stages = 3 if n_sub >= 3 and shared(3, ty) <= MAX_SMEM_BYTES else 2
    return Plan(inst, r, c, tx, ty, stages, pitch, shared(stages, ty))


def fits(config: Mapping, problem: Mapping | None = None) -> bool:
    """Whether csrc/convolution.cu can run this tiling for ``problem``
    (default: the hub size): ``plan`` is not None and the row tiles are at
    most ``MAX_GRID_Y``. Any strip_h x block_w tile runs: the block walks
    it in sub-tiles that fit its shared memory."""
    p = {"h": HUB_H, "fh": HUB_FH, "fw": HUB_FW, **(problem or {})}
    return (plan(config["strip_h"], config["block_w"], p["fh"], p["fw"])
            is not None and -(-p["h"] // config["strip_h"]) <= MAX_GRID_Y)


def _lib() -> ctypes.CDLL:
    lib = cuda.library("convolution")
    if lib.repro_conv2d.argtypes is None:
        limits = [ctypes.c_int() for _ in range(5)]
        lib.repro_conv2d_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 5
        lib.repro_conv2d_limits.restype = None
        lib.repro_conv2d_limits(*map(ctypes.byref, limits))
        got = tuple(v.value for v in limits)
        want = (MAX_FILTER, MAX_THREADS, MAX_STAGES, MAX_SMEM_BYTES,
                COLS_PER_THREAD)
        if got != want:
            raise RuntimeError(f"csrc/convolution.cu limits {got} disagree "
                               f"with the wrapper's {want}")
        lib.repro_conv2d.restype = ctypes.c_int
        lib.repro_conv2d.argtypes = ([ctypes.c_void_p] * 3
                                     + [ctypes.c_int] * 13
                                     + [ctypes.c_void_p])
    return lib


def conv2d_plain(x: torch.Tensor, f: torch.Tensor, **_tiling) -> torch.Tensor:
    """The same function in plain PyTorch (the reference's ``conv2d_ref``):
    same-padded cross-correlation, fh·fw shifted float32 multiply-adds in
    dy-outer, dx-inner order."""
    h, w = x.shape
    fh, fw = f.shape
    ph, pw = fh // 2, fw // 2
    xp = F.pad(x.float(), (pw, fw - 1 - pw, ph, fh - 1 - ph))
    ff = f.float()
    acc = torch.zeros((h, w), dtype=torch.float32, device=x.device)
    for dy in range(fh):
        for dx in range(fw):
            acc += xp[dy:dy + h, dx:dx + w] * ff[dy, dx]
    return acc.to(x.dtype)


def conv2d(x: torch.Tensor, f: torch.Tensor, *, strip_h: int = 64,
           block_w: int = 256) -> torch.Tensor:
    """'Same'-padded 2-D cross-correlation of the (H, W) image ``x`` with
    the (fh, fw) filter ``f``, float32, with the given tiling: the CUDA
    kernel for tensors on the card, ``conv2d_plain`` for tensors on the CPU.
    Raises ``ConfigRejected`` for a tiling ``plan`` or the grid refuses, on
    either device."""
    global launches
    if x.dim() != 2 or f.dim() != 2 or min(*x.shape, *f.shape) < 1:
        raise ValueError(f"conv2d takes a 2-D image and a 2-D filter, got "
                         f"{tuple(x.shape)} and {tuple(f.shape)}")
    if x.dtype != torch.float32 or f.dtype != torch.float32:
        raise ValueError(f"conv2d takes float32 tensors, got {x.dtype} and "
                         f"{f.dtype}")
    if strip_h < 1 or block_w < 1:
        raise ValueError(f"tiles must be positive, got {strip_h}x{block_w}")
    (h, w), (fh, fw) = x.shape, f.shape
    pl = plan(strip_h, block_w, fh, fw)
    if pl is None or -(-h // strip_h) > MAX_GRID_Y:
        raise ConfigRejected(f"tiling ({strip_h},{block_w}) with a {fh}x{fw} "
                             f"filter does not fit csrc/convolution.cu at "
                             f"h={h}")
    if x.device != f.device:
        raise ValueError("conv2d operands lie on different devices")
    if x.device.type == "cpu":
        return conv2d_plain(x, f)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d runs on CUDA or the CPU, not {x.device}")
    if not (x.is_contiguous() and f.is_contiguous()):
        raise ValueError("conv2d takes contiguous row-major tensors")
    lib = _lib()
    out = torch.empty((h, w), dtype=torch.float32, device=x.device)
    rc = lib.repro_conv2d(x.data_ptr(), f.data_ptr(), out.data_ptr(), h, w,
                          fh, fw, strip_h, block_w, pl.filter_width, pl.rows,
                          pl.threads_x, pl.threads_y, pl.stages, pl.pitch,
                          pl.shared_bytes, cuda.stream_handle(x.device))
    cuda.check_launch(lib, rc, "conv2d")
    launches += 1
    return out


# ----------------------------------------------------------- live recording
def make_live(problem: Mapping | None = None, device: str | None = None):
    """``fn(config_dict)`` for the recorder: a fixed float32 image and
    filter on ``device`` (the card unless ``"cpu"`` is asked for), made
    from ``np.random.default_rng``; ``fn`` runs ``conv2d`` with that tiling
    and, on the card, waits for it. The kernel library is built here,
    before any evaluation. The unroll, vector-width and accumulator
    tunables are cost-model-only."""
    p = {**SMOKE_PROBLEM, **(problem or {})}
    dev = cuda.resolve_device(device)
    on_card = dev != "cpu"
    if on_card:
        _lib()
    seed = p.get("seed", 1)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (p["h"], p["w"]), dtype=np.float32)).to(dev)
    f = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (p["fh"], p["fw"]), dtype=np.float32)).to(dev)

    def fn(conf: Mapping) -> None:
        conv2d(x, f, strip_h=conf["strip_h"], block_w=conf["block_w"])
        if on_card:
            torch.cuda.synchronize(dev)

    return fn


# ------------------------------------------------------------ search space
def space(h: int = HUB_H, w: int = HUB_W, fh: int = HUB_FH,
          fw: int = HUB_FW) -> SearchSpace:
    tunables = tunables_from_dict({
        "strip_h": (8, 16, 24, 32, 48, 64, 80, 96, 128, 160, 192, 256, 384,
                    512),
        "block_w": (96, 128, 160, 256, 320, 512, 640, 1024, 1280, 2048, 4096),
        "unroll_fh": (1, 2, 4, 8, 17),
        "acc_dtype": ("f32", "bf16"),
        "vector_w": (128, 256, 512),       # VPU vectorization width hint
    })
    constraints = (
        Constraint(lambda c: c["vector_w"] <= c["block_w"],
                   "vector width within column tile"),
    )
    return SearchSpace(tunables, constraints, name="convolution")


# -------------------------------------------------------------- cost model
def workload(h: int = HUB_H, w: int = HUB_W, fh: int = HUB_FH,
             fw: int = HUB_FW) -> KernelWorkload:
    def _padded(c: Mapping):
        sh, bw = c["strip_h"], c["block_w"]
        return (-(-h // sh) * sh, -(-w // bw) * bw)

    def flops(c: Mapping) -> float:
        hp, wp = _padded(c)
        return 2.0 * hp * wp * fh * fw

    def hbm_bytes(c: Mapping, dev: DeviceModel) -> float:
        sh, bw = c["strip_h"], c["block_w"]
        hp, wp = _padded(c)
        # halo duplication in both dims + one write; small patches stream badly
        blk = (sh + fh - 1) * (bw + fw - 1) * BYTES
        reads = hp * wp * BYTES * ((sh + fh - 1) / sh) * ((bw + fw - 1) / bw)
        return reads / dma_eff(blk) + hp * wp * BYTES / dma_eff(sh * bw * BYTES)

    def vmem_bytes(c: Mapping) -> float:
        sh, bw = c["strip_h"], c["block_w"]
        acc = 4 if c["acc_dtype"] == "f32" else 2
        in_blk = (sh + fh - 1) * (bw + fw - 1) * BYTES
        out_blk = sh * bw * BYTES
        return 2 * (in_blk + out_blk) + sh * bw * acc

    def grid_size(c: Mapping) -> float:
        hp, wp = _padded(c)
        return (hp // c["strip_h"]) * (wp // c["block_w"])

    def compute_eff(c: Mapping, dev: DeviceModel) -> float:
        sh, bw = c["strip_h"], c["block_w"]
        eff = alignment_eff(sh, dev.sublane) * alignment_eff(bw, dev.lane)
        # conv runs on the VPU: peak is ~1/8 of MXU peak for this model
        eff *= 0.125
        # loop unrolling amortizes scalar overhead; too much spills
        unroll = c["unroll_fh"]
        eff *= {1: 0.72, 2: 0.85, 4: 1.0, 8: 0.97, 17: 0.88}[unroll]
        if c["acc_dtype"] == "bf16":
            eff *= 1.08  # fewer register bytes, slightly better issue rate
        # vector width: full-lane vectors best
        eff *= {128: 1.0, 256: 0.99, 512: 0.96}[c["vector_w"]]
        return eff

    return KernelWorkload("convolution", flops, hbm_bytes, vmem_bytes,
                          grid_size, compute_eff)

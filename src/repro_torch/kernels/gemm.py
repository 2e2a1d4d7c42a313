"""GEMM — C = alpha·A·B + beta·C0 (benchmark-hub kernel, CLBlast analogue).

Port of ``src/repro/kernels/gemm.py``. The Pallas TPU kernel
``_gemm_kernel``/``gemm`` becomes the hand-written CUDA kernels of
``csrc/gemm.cu`` (its header says what bounds them on the H100 and how
they are laid out); ``gemm`` here is their wrapper and ``gemm_plain`` the
same function in plain PyTorch. The search space, the problem sizes and
the cost-model ``workload()`` are the reference's, unchanged: the same
tunables in the same order, so config ids agree across the two packages.

Two kernels, chosen by dtype:

  * bfloat16 (the hub's and the live recording's type): wgmma on the
    tensor cores, fed by a TMA/mbarrier ring of shared-memory stages.
  * float32: the CUDA cores (fmaf), because wgmma has no full-float32
    product and TF32 would break tests/test_kernels.py's float32
    tolerance.

``block_m/n/k`` are runtime arguments. ``plan`` decides how one tiling
runs at one shape, on the CPU as on the card, and returns ``None`` for a
tiling the kernel cannot run; ``gemm`` then raises ``ConfigRejected``
before any launch, so a live recording stores it as a failed config on
either device. ``grid_order`` and ``acc_dtype`` stay cost-model-only, as
in the reference.
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
from ..core.tunable import tunables_from_dict

ConfigRejected = cuda.ConfigRejected

# Hub problem size (dense square GEMM, bf16 in / fp32 accumulate)
HUB_M, HUB_N, HUB_K = 4096, 4096, 4096
BYTES = 2  # bf16

# Recording problem size: small enough that a CPU evaluation of the plain
# version takes milliseconds (the reference's interpret-mode smoke size)
SMOKE_PROBLEM = {"m": 128, "n": 128, "k": 128}

# limits of csrc/gemm.cu (checked against the library when it loads)
TILE_M = TILE_N = 8        # fma: accumulator micro-tile of one thread
MAX_THREADS = 512          # fma: __launch_bounds__, <= 128 registers a thread
MAX_SMEM_BYTES = 232448    # dynamic shared memory one block may use
MAX_STAGES = 4             # wgmma: stages of the TMA ring
MAX_CONSUMERS = 3          # wgmma: consumer warpgroups beside the producer
MAX_ACC_COLS = 256         # wgmma: accumulator columns of one warpgroup
MAX_ACC_COLS_3 = 128       # ... of three (512 threads: 128 registers each)
SMEM_RESERVED = 1088       # wgmma: 1024-byte alignment slack + 8 mbarriers
MAX_BOX = 256              # TMA: box extent in each dimension
MAX_GRID_Y = 65535         # row tiles per launch
TMA_ALIGN = 8              # bf16 elements in TMA's 16-byte stride unit

# kernel launches by ``gemm`` (plain-version calls on the CPU do not count)
launches = 0


# ----------------------------------------------------------------- kernel
@dataclass(frozen=True)
class Plan:
    """How csrc/gemm.cu runs one tiling at one shape.

    ``path`` is ``"wgmma"`` (bfloat16) or ``"fma"`` (float32), ``threads``
    a block's. On the fma path ``rows`` is ``block_m`` and the wgmma
    fields are 0. On the wgmma path a block has ``warpgroups`` consumer
    warpgroups and one producer warpgroup; ``rows`` is ``block_m``
    rounded up to 64 (wgmma's M);
    ``block_n`` is ``pieces`` instructions of width ``wgmma_n``; each
    consumer holds ``frags`` accumulator fragments of 64 × ``wgmma_n``;
    ``swizzle_a``/``swizzle_b`` are the shared-memory swizzles of A (by K)
    and B (by N) in bytes; ``padded`` says that k or n is not a multiple
    of 8 and the wrapper zero-pads them (TMA strides are 16-byte units).
    """
    path: str
    threads: int
    rows: int
    stages: int = 1
    wgmma_n: int = 0
    pieces: int = 0
    warpgroups: int = 0
    frags: int = 0
    swizzle_a: int = 0
    swizzle_b: int = 0
    padded: bool = False


def _swizzle(extent: int) -> int:
    """The widest swizzle (bytes) whose span of bf16 elements divides
    ``extent``: 128 (64 elements), 64 (32) or 32 (16)."""
    return next(s for s in (128, 64, 32) if extent % (s // BYTES) == 0)


def _wgmma_split(bn: int) -> tuple[int, int] | None:
    """``(N, pieces)``: ``block_n`` as the fewest equal wgmma widths of at
    most 256 columns that are multiples of 32, or None."""
    for pieces in range(1, bn // 32 + 1):
        if bn % pieces == 0 and bn // pieces <= 256 \
                and (bn // pieces) % 32 == 0:
            return bn // pieces, pieces
    return None


def plan(config: Mapping, m: int, n: int, k: int,
         dtype: torch.dtype) -> Plan | None:
    """The launch plan of one tiling at one shape, or None where the
    kernel cannot run it.

    float32 (fma): ``(bm/8)*(bn/8)`` threads within ``MAX_THREADS`` and
    ``(bm+bn)*bk`` staged floats within ``MAX_SMEM_BYTES``.

    bfloat16 (wgmma), the rule: ``rows = ceil(bm/64)*64``; ``block_n``
    splits into ``pieces`` of width N (``_wgmma_split``); the ``rows/64 *
    pieces`` fragments go evenly to the most consumer warpgroups (3, 2 or
    1) that leave each at most ``MAX_ACC_COLS`` accumulator columns
    (``frags * N``, 128 floats a thread), ``MAX_ACC_COLS_3`` where there
    are three (a 512-thread block holds ptxas to 128 registers a thread);
    ``stages = min(MAX_STAGES, (MAX_SMEM_BYTES - SMEM_RESERVED) //
    ((rows + bn) * bk * 2))``, at least 1; block_k gives A's swizzle, N
    gives B's (``_swizzle``); block_m and block_k split into equal TMA
    boxes of at most ``MAX_BOX`` rows. Over the hub space this refuses
    7,708 of the 10,140 tilings. Either path: at most ``MAX_GRID_Y`` row
    tiles."""
    bm, bn, bk = config["block_m"], config["block_n"], config["block_k"]
    if -(-m // bm) > MAX_GRID_Y:
        return None
    if dtype == torch.float32:
        if bm % TILE_M or bn % TILE_N:
            return None
        threads = (bm // TILE_M) * (bn // TILE_N)
        smem = (bm + bn) * bk * dtype.itemsize
        if threads > MAX_THREADS or smem > MAX_SMEM_BYTES:
            return None
        return Plan("fma", threads, bm)
    if dtype != torch.bfloat16 or bm % 8 or bk % 16 \
            or any(x % -(-x // MAX_BOX) for x in (bm, bk)):
        return None
    split = _wgmma_split(bn)
    if split is None:
        return None
    wgmma_n, pieces = split
    rows = -(-bm // 64) * 64
    total = rows // 64 * pieces
    warpgroups = next((w for w in range(MAX_CONSUMERS, 0, -1)
                       if total % w == 0 and total // w * wgmma_n
                       <= (MAX_ACC_COLS_3 if w == 3 else MAX_ACC_COLS)),
                      None)
    if warpgroups is None:
        return None
    stage_bytes = (rows + bn) * bk * BYTES
    stages = min(MAX_STAGES, (MAX_SMEM_BYTES - SMEM_RESERVED) // stage_bytes)
    if stages < 1:
        return None
    return Plan("wgmma", 128 * (warpgroups + 1), rows, stages, wgmma_n,
                pieces, warpgroups, total // warpgroups, _swizzle(bk),
                _swizzle(wgmma_n), bool(k % TMA_ALIGN or n % TMA_ALIGN))


def fits(config: Mapping, dtype: torch.dtype) -> bool:
    """Whether csrc/gemm.cu can run this tiling on an H100: its ``plan``
    at the hub shape is not None."""
    return plan(config, HUB_M, HUB_N, HUB_K, dtype) is not None


def pad_operands(a: torch.Tensor, b: torch.Tensor, c0: torch.Tensor):
    """``(a, b, c0)`` with k and n zero-padded up to multiples of 8, as
    TMA's 16-byte row strides need (the reference pads with ``jnp.pad``
    likewise). The zero columns of ``a`` meet the zero rows of ``b``, so
    ``out[:, :n]`` of the padded product is the product."""
    m, k = a.shape
    n = b.shape[1]
    dk, dn = -k % TMA_ALIGN, -n % TMA_ALIGN
    return F.pad(a, (0, dk)), F.pad(b, (0, dn, 0, dk)), F.pad(c0, (0, dn))


def _lib() -> ctypes.CDLL:
    lib = cuda.library("gemm")
    if lib.repro_gemm_bf16.argtypes is None:
        limits = [ctypes.c_int() for _ in range(10)]
        lib.repro_gemm_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 10
        lib.repro_gemm_limits.restype = None
        lib.repro_gemm_limits(*map(ctypes.byref, limits))
        got = tuple(v.value for v in limits)
        want = (TILE_M, TILE_N, MAX_THREADS, MAX_SMEM_BYTES, MAX_STAGES,
                MAX_CONSUMERS, MAX_ACC_COLS, MAX_ACC_COLS_3, SMEM_RESERVED,
                MAX_BOX)
        if got != want:
            raise RuntimeError(f"csrc/gemm.cu limits {got} disagree with "
                               f"the wrapper's {want}")
        lib.repro_gemm_f32.restype = ctypes.c_int
        lib.repro_gemm_f32.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
            + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        lib.repro_gemm_bf16.restype = ctypes.c_int
        lib.repro_gemm_bf16.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 14
            + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    return lib


def gemm_plain(a: torch.Tensor, b: torch.Tensor, c0: torch.Tensor, *,
               alpha: float = 1.0, beta: float = 1.0,
               **_tiling) -> torch.Tensor:
    """The same function in plain PyTorch (the reference's ``gemm_ref``):
    float32 product of the upcast operands, then the epilogue, rounded to
    ``a.dtype``."""
    acc = a.float() @ b.float()
    return (alpha * acc + beta * c0.float()).to(a.dtype)


def gemm(a: torch.Tensor, b: torch.Tensor, c0: torch.Tensor, *,
         block_m: int = 128, block_n: int = 128, block_k: int = 128,
         alpha: float = 1.0, beta: float = 1.0) -> torch.Tensor:
    """``alpha·a@b + beta·c0`` with the given tiling: the CUDA kernel of
    ``a.dtype`` for tensors on the card, ``gemm_plain`` for tensors on the
    CPU. Raises ``ConfigRejected`` for a tiling ``plan`` refuses, on
    either device."""
    global launches
    if a.dim() != 2 or b.dim() != 2 or c0.dim() != 2:
        raise ValueError("gemm takes 2-D operands")
    m, k = a.shape
    k2, n = b.shape
    if k != k2 or tuple(c0.shape) != (m, n) or min(m, n, k) < 1:
        raise ValueError(f"shapes do not chain: a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}, c0 {tuple(c0.shape)}")
    if a.dtype not in (torch.float32, torch.bfloat16) or b.dtype != a.dtype \
            or c0.dtype != a.dtype:
        raise ValueError(f"gemm takes float32 or bfloat16 operands of one "
                         f"type, got {a.dtype}, {b.dtype}, {c0.dtype}")
    conf = {"block_m": block_m, "block_n": block_n, "block_k": block_k}
    pl = plan(conf, m, n, k, a.dtype)
    if pl is None:
        raise ConfigRejected(f"tiling {conf} does not fit one block of "
                             f"csrc/gemm.cu for {a.dtype} at m={m}")
    if a.device != b.device or a.device != c0.device:
        raise ValueError("gemm operands lie on different devices")
    if a.device.type == "cpu":
        return gemm_plain(a, b, c0, alpha=alpha, beta=beta)
    if a.device.type != "cuda":
        raise ValueError(f"gemm runs on CUDA or the CPU, not {a.device}")
    if not (a.is_contiguous() and b.is_contiguous() and c0.is_contiguous()):
        raise ValueError("gemm takes contiguous row-major operands")
    lib = _lib()
    stream = cuda.stream_handle(a.device)
    if pl.path == "fma":
        out = torch.empty((m, n), dtype=a.dtype, device=a.device)
        rc = lib.repro_gemm_f32(a.data_ptr(), b.data_ptr(), c0.data_ptr(),
                                out.data_ptr(), m, n, k, block_m, block_n,
                                block_k, float(alpha), float(beta), stream)
    else:
        if pl.padded:
            a, b, c0 = pad_operands(a, b, c0)
        # TMA reads from 16-byte aligned addresses: copy an offset view
        a, b, c0 = (t if t.data_ptr() % 16 == 0 else t.clone()
                    for t in (a, b, c0))
        kp, np_ = a.shape[1], b.shape[1]
        out = torch.empty((m, np_), dtype=a.dtype, device=a.device)
        rc = lib.repro_gemm_bf16(
            a.data_ptr(), b.data_ptr(), c0.data_ptr(), out.data_ptr(), m,
            np_, kp, block_m, block_n, block_k, pl.rows, pl.stages,
            pl.wgmma_n, pl.pieces, pl.warpgroups, pl.frags, pl.swizzle_a,
            pl.swizzle_b, float(alpha), float(beta), stream)
    cuda.check_launch(lib, rc, "gemm")
    launches += 1
    return out[:, :n]


# ----------------------------------------------------------- live recording
def make_live(problem: Mapping | None = None, device: str | None = None):
    """``fn(config_dict)`` for the recorder: fixed bf16 operands on
    ``device`` (the card unless ``"cpu"`` is asked for), made from
    ``np.random.default_rng(seed)``; ``fn`` runs ``gemm`` with that tiling
    and, on the card, waits for it (``torch.cuda.synchronize``). The kernel
    library is built here, before any evaluation, so a failed build raises
    instead of being recorded as failed configs. Tunables the kernel does
    not consume (grid order, accumulator dtype) are cost-model-only."""
    p = {**SMOKE_PROBLEM, **(problem or {})}
    dev = cuda.resolve_device(device)
    on_card = dev != "cpu"
    if on_card:
        _lib()
    rng = np.random.default_rng(p.get("seed", 0))

    def operand(shape):
        x = rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(x).to(device=dev, dtype=torch.bfloat16)

    a = operand((p["m"], p["k"]))
    b = operand((p["k"], p["n"]))
    c0 = operand((p["m"], p["n"]))

    def fn(conf: Mapping) -> None:
        gemm(a, b, c0, block_m=conf["block_m"], block_n=conf["block_n"],
             block_k=conf["block_k"])
        if on_card:
            torch.cuda.synchronize(dev)

    return fn


# ------------------------------------------------------------ search space
def space(m: int = HUB_M, n: int = HUB_N, k: int = HUB_K) -> SearchSpace:
    tunables = tunables_from_dict({
        "block_m": (8, 16, 24, 32, 48, 64, 96, 128, 160, 192, 256, 320, 384,
                    448, 512),
        "block_n": (64, 96, 128, 160, 192, 256, 320, 384, 512, 640, 768, 896,
                    1024),
        "block_k": (32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536,
                    2048),
        "grid_order": ("mn", "nm"),          # output-stationary sweep order
        "acc_dtype": ("f32", "bf16"),        # accumulator precision
    })
    # non-dividing blocks are legal (zero-padded) — the padding waste is
    # costed, so the space is rich in mediocre configurations, like real
    # auto-tuning spaces.
    return SearchSpace(tunables, (), name="gemm")


# -------------------------------------------------------------- cost model
def workload(m: int = HUB_M, n: int = HUB_N, k: int = HUB_K) -> KernelWorkload:
    def _padded(c: Mapping):
        bm, bn, bk = c["block_m"], c["block_n"], c["block_k"]
        return (-(-m // bm) * bm, -(-n // bn) * bn, -(-k // bk) * bk)

    def flops(c: Mapping) -> float:
        mp, np_, kp = _padded(c)
        return 2.0 * mp * np_ * kp + 3.0 * mp * np_  # incl. padding waste

    def hbm_bytes(c: Mapping, dev: DeviceModel) -> float:
        bm, bn, bk = c["block_m"], c["block_n"], c["block_k"]
        mp, np_, kp = _padded(c)
        # A is re-read for every N-tile, B for every M-tile; C0/out once.
        n_m, n_n = mp // bm, np_ // bn
        a_reads = mp * kp * BYTES * n_n / dma_eff(bm * bk * BYTES)
        b_reads = kp * np_ * BYTES * n_m / dma_eff(bk * bn * BYTES)
        c_traffic = 2 * mp * np_ * BYTES / dma_eff(bm * bn * BYTES)
        return a_reads + b_reads + c_traffic

    def vmem_bytes(c: Mapping) -> float:
        bm, bn, bk = c["block_m"], c["block_n"], c["block_k"]
        acc = 4 if c["acc_dtype"] == "f32" else 2
        # double-buffered in/out blocks + accumulator scratch
        return 2 * (bm * bk + bk * bn + 2 * bm * bn) * BYTES + bm * bn * acc

    def grid_size(c: Mapping) -> float:
        mp, np_, kp = _padded(c)
        return ((mp // c["block_m"]) * (np_ // c["block_n"])
                * (kp // c["block_k"]))

    def compute_eff(c: Mapping, dev: DeviceModel) -> float:
        bm, bn, bk = c["block_m"], c["block_n"], c["block_k"]
        eff = (alignment_eff(bm, dev.sublane)
               * alignment_eff(bn, dev.lane)
               * alignment_eff(bk, dev.lane))
        # MXU likes >= mxu-sized matmul dims; smaller tiles underfill it
        eff *= min(1.0, bm / dev.mxu) ** 0.5
        # bf16 accumulate halves epilogue traffic but costs extra passes on
        # the MXU for large K (numerical chunking): mild penalty
        if c["acc_dtype"] == "bf16":
            eff *= 0.92
        # "nm" order is slightly worse for row-major A prefetch
        if c["grid_order"] == "nm":
            eff *= 0.97
        return eff

    return KernelWorkload("gemm", flops, hbm_bytes, vmem_bytes, grid_size,
                          compute_eff)

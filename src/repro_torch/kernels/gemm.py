"""GEMM — C = alpha·A·B + beta·C0 (benchmark-hub kernel, CLBlast analogue).

Port of ``src/repro/kernels/gemm.py``. The Pallas TPU kernel
``_gemm_kernel``/``gemm`` becomes the hand-written CUDA kernel
``csrc/gemm.cu`` (its header says what bounds it on the H100 and how it is
laid out); ``gemm`` here is its wrapper and ``gemm_plain`` the same
function in plain PyTorch. The search space, the problem sizes and the
cost-model ``workload()`` are the reference's, unchanged: the same
tunables in the same order, so config ids agree across the two packages.

``block_m/n/k`` are runtime arguments of one compiled kernel. A tiling the
kernel cannot run on the card (``fits`` is false: too many threads or too
much shared memory for one block) raises ``ConfigRejected`` before any
launch, on the CPU as on the card, so a live recording stores it as a
failed config either way. ``grid_order`` and ``acc_dtype`` stay
cost-model-only, as in the reference.
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
from ..core.tunable import tunables_from_dict

ConfigRejected = cuda.ConfigRejected

# Hub problem size (dense square GEMM, bf16 in / fp32 accumulate)
HUB_M, HUB_N, HUB_K = 4096, 4096, 4096
BYTES = 2  # bf16

# Recording problem size: small enough that a CPU evaluation of the plain
# version takes milliseconds (the reference's interpret-mode smoke size)
SMOKE_PROBLEM = {"m": 128, "n": 128, "k": 128}

# limits of csrc/gemm.cu (checked against the library when it loads)
TILE_M = TILE_N = 8        # accumulator micro-tile of one thread
MAX_THREADS = 512          # __launch_bounds__: <= 128 registers a thread
MAX_SMEM_BYTES = 232448    # dynamic shared memory one block may use
MAX_GRID_Y = 65535         # row tiles per launch
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches by ``gemm`` (plain-version calls on the CPU do not count)
launches = 0


# ----------------------------------------------------------------- kernel
def fits(config: Mapping, dtype: torch.dtype) -> bool:
    """Whether csrc/gemm.cu can run this tiling on an H100: one block's
    ``(bm/8)*(bn/8)`` threads within ``MAX_THREADS`` and its
    ``(bm+bn)*bk`` staged elements within ``MAX_SMEM_BYTES``."""
    bm, bn, bk = config["block_m"], config["block_n"], config["block_k"]
    if bm % TILE_M or bn % TILE_N:
        return False
    threads = (bm // TILE_M) * (bn // TILE_N)
    smem = (bm + bn) * bk * dtype.itemsize
    return threads <= MAX_THREADS and smem <= MAX_SMEM_BYTES


def _lib() -> ctypes.CDLL:
    lib = cuda.library("gemm")
    if lib.repro_gemm.argtypes is None:
        limits = [ctypes.c_int() for _ in range(4)]
        lib.repro_gemm_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
        lib.repro_gemm_limits.restype = None
        lib.repro_gemm_limits(*map(ctypes.byref, limits))
        got = tuple(v.value for v in limits)
        want = (TILE_M, TILE_N, MAX_THREADS, MAX_SMEM_BYTES)
        if got != want:
            raise RuntimeError(f"csrc/gemm.cu limits {got} disagree with "
                               f"the wrapper's {want}")
        lib.repro_gemm.restype = ctypes.c_int
        lib.repro_gemm.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
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
    """``alpha·a@b + beta·c0`` with the given tiling: the CUDA kernel for
    tensors on the card, ``gemm_plain`` for tensors on the CPU. Raises
    ``ConfigRejected`` for a tiling ``fits`` refuses, on either device."""
    global launches
    if a.dim() != 2 or b.dim() != 2 or c0.dim() != 2:
        raise ValueError("gemm takes 2-D operands")
    m, k = a.shape
    k2, n = b.shape
    if k != k2 or tuple(c0.shape) != (m, n) or min(m, n, k) < 1:
        raise ValueError(f"shapes do not chain: a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}, c0 {tuple(c0.shape)}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype \
            or c0.dtype != a.dtype:
        raise ValueError(f"gemm takes float32 or bfloat16 operands of one "
                         f"type, got {a.dtype}, {b.dtype}, {c0.dtype}")
    conf = {"block_m": block_m, "block_n": block_n, "block_k": block_k}
    if not fits(conf, a.dtype) or -(-m // block_m) > MAX_GRID_Y:
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
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    rc = lib.repro_gemm(_DTYPE_CODE[a.dtype], a.data_ptr(), b.data_ptr(),
                        c0.data_ptr(), out.data_ptr(), m, n, k, block_m,
                        block_n, block_k, float(alpha), float(beta),
                        cuda.stream_handle(a.device))
    cuda.check_launch(lib, rc, "gemm")
    launches += 1
    return out


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

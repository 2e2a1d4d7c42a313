"""Flash attention (forward): fused online-softmax attention.

Port of ``src/repro/kernels/flash_attention.py``. The Pallas TPU kernel
``_attn_kernel``/``flash_attention`` becomes the hand-written CUDA kernel
``csrc/flash_attention.cu`` (its header says what bounds it on the H100,
how a tile larger than shared memory is walked, and which fully masked kv
tiles it skips); ``flash_attention`` here is its wrapper and
``attention_plain`` the same function in plain PyTorch: the reference's
``attention_ref``, S x S float32 logits per head with the finite
``NEG_INF`` mask, then a softmax. The search space, the problem sizes and
the cost-model ``workload()`` are the reference's, unchanged, so config
ids agree across the two packages.

``block_q`` and ``block_kv`` are runtime arguments of one compiled kernel.
``acc_dtype`` stays cost-model-only, as in the reference's ``make_live``.
A problem the kernel cannot run (``fits`` is false: a head dimension
above 128) raises ``ConfigRejected`` before any launch, on the CPU as on
the card.
"""
from __future__ import annotations

import ctypes
from typing import Mapping

import torch

from .. import cuda
from ..core.costmodel import KernelWorkload, alignment_eff
from ..core.devices import DeviceModel
from ..core.searchspace import SearchSpace
from ..core.tunable import Constraint, tunables_from_dict

ConfigRejected = cuda.ConfigRejected

NEG_INF = -1e30

# Recording problem size (CPU interpret-mode live tuning): 4 q heads over a
# GQA group of 2, short sequence
SMOKE_PROBLEM = {"bh": 4, "bh_kv": 2, "seq": 256, "d": 64}

# limit of csrc/flash_attention.cu (checked against the library when it
# loads): the head dimensions its shared-memory staging holds
MAX_D = 128

# kernel launches by ``flash_attention`` (plain-version calls on the CPU do
# not count)
launches = 0


# ----------------------------------------------------------------- kernel
def fits(config: Mapping, problem: Mapping | None = None) -> bool:
    """Whether csrc/flash_attention.cu can run this tiling for ``problem``
    (default: the smoke size): a head dimension of at most ``MAX_D``. Any
    block_q x block_kv tile runs: the block walks it in sub-tiles that fit
    its shared memory."""
    p = {**SMOKE_PROBLEM, **(problem or {})}
    return 1 <= p["d"] <= MAX_D


def _lib() -> ctypes.CDLL:
    lib = cuda.library("flash_attention")
    if lib.repro_flash_attention.argtypes is None:
        limit = ctypes.c_int()
        lib.repro_flash_attention_limits.argtypes = [
            ctypes.POINTER(ctypes.c_int)]
        lib.repro_flash_attention_limits.restype = None
        lib.repro_flash_attention_limits(ctypes.byref(limit))
        if limit.value != MAX_D:
            raise RuntimeError(f"csrc/flash_attention.cu head-dim limit "
                               f"{limit.value} disagrees with the wrapper's "
                               f"{MAX_D}")
        lib.repro_flash_attention.restype = ctypes.c_int
        lib.repro_flash_attention.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                          ctypes.c_int,
                                                          ctypes.c_void_p])
    return lib


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """The same function in plain PyTorch (the reference's
    ``attention_ref``): float32 logits over the whole S x S square per
    head, masked with the finite ``NEG_INF``, a softmax, then the product
    with v; the result in q's dtype."""
    bh, s, d = q.shape
    group = bh // k.shape[0]
    kf = torch.repeat_interleave(k, group, dim=0).float()
    vf = torch.repeat_interleave(v, group, dim=0).float()
    logits = torch.einsum("hqd,hkd->hqk", q.float(), kf) / (d ** 0.5)
    q_pos = torch.arange(s, device=q.device)[:, None]
    kv_pos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= kv_pos
    if window is not None:
        mask &= (q_pos - kv_pos) < window
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, vf).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    block_q: int = 128, block_kv: int = 128,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """q: (BH, S, D); k/v: (BH_kv, S, D) with BH % BH_kv == 0 (GQA: q head
    h reads kv head h // (BH / BH_kv)), float32 or bf16, the reference's
    layout. The CUDA kernel for tensors on the card, ``attention_plain``
    for tensors on the CPU. Raises ``ConfigRejected`` for a problem
    ``fits`` refuses, on either device."""
    global launches
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 \
            or k.shape[1:] != q.shape[1:]:
        raise ValueError(f"flash_attention takes q (BH, S, D) and k, v "
                         f"(BH_kv, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes float32 or bf16 tensors of "
                         f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    bh, s, d = q.shape
    bh_kv = k.shape[0]
    if block_q < 1 or block_kv < 1:
        raise ValueError(f"tiles must be positive, got {block_q}x{block_kv}")
    # the reference's asserts (flash_attention.py:95-97), kept under -O
    if bh % bh_kv or s % block_q or s % block_kv:
        raise AssertionError(f"{bh} q heads over {bh_kv} kv heads, {s} "
                             f"tokens in tiles of {block_q}x{block_kv}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    conf = {"block_q": block_q, "block_kv": block_kv}
    if not fits(conf, {"d": d}):
        raise ConfigRejected(f"tiling {conf} with d={d} does not fit "
                             f"csrc/flash_attention.cu")
    if not q.device == k.device == v.device:
        raise ValueError("flash_attention operands lie on different devices")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or the CPU, not "
                         f"{q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous tensors")
    lib = _lib()
    out = torch.empty_like(q)
    rc = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s, d,
        bh // bh_kv, block_q, block_kv, int(causal),
        -1 if window is None else window, 1.0 / (d ** 0.5),
        int(q.dtype == torch.bfloat16), cuda.stream_handle(q.device))
    cuda.check_launch(lib, rc, "flash_attention")
    launches += 1
    return out


# ----------------------------------------------------------- live recording
def make_live(problem: Mapping | None = None, device: str | None = None):
    """``fn(config_dict)`` for the recorder: causal GQA attention on fixed
    float32 q/k/v on ``device`` (the card unless ``"cpu"`` is asked for),
    drawn from a ``torch.Generator`` seeded by ``problem["seed"]``; ``fn``
    runs ``flash_attention`` with that tiling and, on the card, waits for
    it. The kernel library is built here, before any evaluation. The
    accumulator-dtype tunable is cost-model-only."""
    p = {**SMOKE_PROBLEM, **(problem or {})}
    dev = cuda.resolve_device(device)
    on_card = dev != "cpu"
    if on_card:
        _lib()
    gen = torch.Generator(device=dev).manual_seed(p.get("seed", 6))
    q, k, v = (torch.randn((n, p["seq"], p["d"]), generator=gen, device=dev)
               for n in (p["bh"], p["bh_kv"], p["bh_kv"]))

    def fn(conf: Mapping) -> None:
        flash_attention(q, k, v, block_q=conf["block_q"],
                        block_kv=conf["block_kv"], causal=True)
        if on_card:
            torch.cuda.synchronize(dev)

    return fn


# ------------------------------------------------------------ search space
def space(seq: int = 4096, d: int = 128) -> SearchSpace:
    tunables = tunables_from_dict({
        "block_q": (64, 128, 256, 512, 1024),
        "block_kv": (128, 256, 512, 1024, 2048),
        "acc_dtype": ("f32", "bf16"),
    })
    constraints = (
        Constraint(lambda c: seq % c["block_q"] == 0, "block_q divides S"),
        Constraint(lambda c: seq % c["block_kv"] == 0, "block_kv divides S"),
    )
    return SearchSpace(tunables, constraints, name="flash_attention")


# -------------------------------------------------------------- cost model
def workload(bh: int = 32, seq: int = 4096, d: int = 128,
             causal: bool = True) -> KernelWorkload:
    frac = 0.5 if causal else 1.0  # causal halves useful work

    def flops(c: Mapping) -> float:
        return 4.0 * bh * seq * seq * d * frac  # qk^T + pv

    def hbm_bytes(c: Mapping, dev: DeviceModel) -> float:
        bq, bkv = c["block_q"], c["block_kv"]
        # k/v streamed once per q block
        kv_reads = 2 * bh * seq * d * 2 * (seq // bq) * frac
        qo = 2 * bh * seq * d * 2
        return kv_reads + qo

    def vmem_bytes(c: Mapping) -> float:
        bq, bkv = c["block_q"], c["block_kv"]
        acc = 4 if c["acc_dtype"] == "f32" else 2
        return (2 * (bq * d + 2 * bkv * d + bq * d) * 2
                + bq * d * acc + bq * bkv * 4 + 2 * bq * 4)

    def grid_size(c: Mapping) -> float:
        return bh * (seq // c["block_q"]) * (seq // c["block_kv"]) * frac

    def compute_eff(c: Mapping, dev: DeviceModel) -> float:
        bq, bkv = c["block_q"], c["block_kv"]
        eff = alignment_eff(bq, dev.mxu) * alignment_eff(bkv, dev.lane)
        eff *= min(1.0, bkv / dev.mxu) ** 0.5
        if c["acc_dtype"] == "bf16":
            eff *= 0.9  # extra rescaling passes
        return 0.75 * eff  # softmax/VPU overhead between the two matmuls

    return KernelWorkload("flash_attention", flops, hbm_bytes, vmem_bytes,
                          grid_size, compute_eff)

"""Flash attention (forward): fused online-softmax attention.

Port of ``src/repro/kernels/flash_attention.py``. The Pallas TPU kernel
``_attn_kernel``/``flash_attention`` becomes the hand-written CUDA kernel
``csrc/flash_attention.cu`` (its header says what bounds it on the H100
and what its design does about it: row groups of 8 lanes that hold scores,
accumulator and softmax state in registers, operands read as float4 from
shared memory, k/v sub-tiles staged by a ``cp.async`` ring, masks only on
the sub-tiles that need them); ``flash_attention`` here is its wrapper and
``attention_plain`` the same function in plain PyTorch: the reference's
``attention_ref``, Sq x Skv float32 logits per head with the finite
``NEG_INF`` mask, then a softmax. The search space, the problem sizes and
the cost-model ``workload()`` are the reference's, unchanged, so config
ids agree across the two packages.

``plan`` turns a tiling into the kernel's instantiation and launch shape,
on the CPU as on the card; ``block_q`` and ``block_kv`` keep their meaning
(one block a (head, block_q) q tile, the visited kv tiles walked in
order). ``acc_dtype`` stays cost-model-only, as in the reference's
``make_live``. A problem the kernel cannot run (``fits`` is false: a head
dimension above 256) raises ``ConfigRejected`` before any launch, on the
CPU as on the card.

``flash_attention(..., return_lse=True)`` also returns each q row's
logsumexp, which the kernel writes beside the output (a null pointer
otherwise, so a call that does not ask pays nothing): the statistic the
model's attention backward (``models/attention.py``) recomputes the
probabilities from, as the reference's custom VJP does.

What the reference's Pallas kernel does not take and the port's call
site needs (``models/attention.py``, whose reference, ``blockwise_attention``,
takes both): q and k/v of different lengths Sq and Skv (whisper's
cross-attention, 256 decoder tokens over 1,500 encoder frames), and a
key-length bound ``kv_len``: the keys from ``kv_len`` on are a pad,
masked with ``NEG_INF`` as the reference masks its pad, and the kernel
visits no tile and no sub-tile of pad alone. A causal or window mask
needs Sq == Skv (the reference's models ask for no other).

``flash_attention`` goes through the operator
``torch.ops.repro_torch.flash_attention`` (``torch.library.custom_op``):
its implementation is the launch (the plain version on the CPU), its
fake implementation gives fake tensors the output shapes, and its flop
formula, ``workload().flops``, lets PyTorch's flop counting see the
kernel, so the dry run traces models through it. ``launches`` counts
as before; ``launch`` calls the same code without the dispatcher, for
``make_live``'s recordings.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Mapping

import torch
from torch.utils.flop_counter import register_flop_formula

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

# limits of csrc/flash_attention.cu (checked against the library when it
# loads): the head dimensions its shared-memory staging holds, the q rows a
# row group owns, the ring's slots (each a k or a v sub-tile)
MAX_D = 256
ROWS = 4
STAGES = 3
LANES = 8                # lanes of a row group
# (threads, kv rows a sub-tile) of the two block shapes the kernel is built
# for: a 128-row q sub-tile in one 256-thread block an SM, and a 64-row one
# in two 128-thread blocks an SM
WIDE, NARROW = (256, 64), (128, 32)
# the kernel's instantiations: (bf16, d_max, threads, sub_kv); d_max 256
# only in the narrow block (the wide one's staging exceeds a block's
# shared memory), two blocks sharing each q tile's output columns
INSTANTIATIONS = tuple(
    (bf16, d_max, *shape) for bf16 in (0, 1) for d_max in (64, 128, MAX_D)
    for shape in ((WIDE, NARROW) if d_max <= 128 else (NARROW,)))

# kernel launches by ``flash_attention`` (plain-version calls on the CPU do
# not count)
launches = 0


# ----------------------------------------------------------------- kernel
@dataclass(frozen=True)
class Plan:
    """How csrc/flash_attention.cu runs one tiling: the instantiation
    (``bf16``, ``d_max``, ``threads``, ``sub_kv``); the rest follows.

    ``threads`` threads make ``threads / 8`` row groups of 8 lanes; a group
    owns ``rows`` rows of each q sub-tile of ``sub_q`` rows (row r·groups +
    group) for the scores, and two neighbouring groups share their rows
    for the accumulator. The block stages the q sub-tile once and k and v
    sub-tiles of ``sub_kv`` rows through a ring of ``stages`` slots (k of
    a sub-tile, then its v), all as float32 rows of ``pitch`` =
    ``d_max`` + 4 floats (head dims up to ``d_max``, the rest zero). At
    ``d_max`` 256 two blocks share each q tile, each owning one 128-column
    half of v and of the output (``col_blocks``)."""
    bf16: bool
    d_max: int
    threads: int
    sub_kv: int
    rows = ROWS
    stages = STAGES

    @property
    def groups(self) -> int:
        return self.threads // LANES

    @property
    def sub_q(self) -> int:
        return self.groups * ROWS

    @property
    def pitch(self) -> int:
        return self.d_max + 4

    @property
    def col_blocks(self) -> int:
        """Blocks that share one (head, q tile), each owning its columns
        of v and of the output."""
        return 2 if self.d_max > 128 else 1

    @property
    def instantiation(self) -> str:
        return (f"attn_kernel<{'bf16' if self.bf16 else 'f32'}, D "
                f"{self.d_max}, {self.threads} threads, sub_kv "
                f"{self.sub_kv}>")

    def q_sub_tiles(self, block_q: int) -> int:
        """Q sub-tiles a block walks for one q tile."""
        return -(-block_q // self.sub_q)


@functools.lru_cache(maxsize=None)
def plan(block_q: int, block_kv: int, s: int, d: int,
         dtype: torch.dtype = torch.float32,
         skv: int | None = None) -> Plan | None:
    """The launch plan of one tiling for ``s`` query tokens over ``skv``
    keys (default ``s``) and head dimension ``d``, or None where the
    kernel cannot run it (a tile below 1, a q tile not dividing ``s`` or
    a kv tile not dividing ``skv``, d outside 1..``MAX_D``, a dtype other
    than float32 and bf16). The rule: head dims staged to 64 when d <= 64,
    to 128 when d <= 128, else to 256; a q tile of at most 64 rows, or any
    q tile at d above 128, takes the ``NARROW`` block (64-row q and 32-row
    kv sub-tiles), a larger one the ``WIDE`` block (128-row q and 64-row kv
    sub-tiles)."""
    skv = s if skv is None else skv
    if (dtype not in (torch.float32, torch.bfloat16) or not 1 <= d <= MAX_D
            or block_q < 1 or block_kv < 1 or s < 1 or skv < 1
            or s % block_q or skv % block_kv):
        return None
    d_max = 64 if d <= 64 else 128 if d <= 128 else MAX_D
    return Plan(dtype == torch.bfloat16, d_max,
                *(NARROW if block_q <= 64 or d_max > 128 else WIDE))


def fits(config: Mapping, problem: Mapping | None = None) -> bool:
    """Whether csrc/flash_attention.cu can run this tiling for ``problem``
    (default: the smoke size): its ``plan`` is not None, so a head
    dimension of at most ``MAX_D`` and tiles that divide the sequence. Any
    block_q x block_kv tile runs: the block walks it in sub-tiles that fit
    its shared memory."""
    p = {**SMOKE_PROBLEM, **(problem or {})}
    return plan(config["block_q"], config["block_kv"], p["seq"],
                p["d"]) is not None


def _lib() -> ctypes.CDLL:
    lib = cuda.library("flash_attention")
    if lib.repro_flash_attention.argtypes is None:
        limits = [ctypes.c_int() for _ in range(3)]
        lib.repro_flash_attention_limits.argtypes = [
            ctypes.POINTER(ctypes.c_int)] * 3
        lib.repro_flash_attention_limits.restype = None
        lib.repro_flash_attention_limits(*map(ctypes.byref, limits))
        got = tuple(x.value for x in limits)
        want = (MAX_D, ROWS, STAGES)
        if got != want:
            raise RuntimeError(f"csrc/flash_attention.cu limits {got} "
                               f"disagree with the wrapper's {want}")
        lib.repro_flash_attention.restype = ctypes.c_int
        lib.repro_flash_attention.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_float]
            + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return lib


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    return_lse: bool = False, kv_len: int | None = None):
    """The same function in plain PyTorch (the reference's
    ``attention_ref``): float32 logits over the whole Sq x Skv rectangle
    per head, masked with the finite ``NEG_INF`` (also every key from
    ``kv_len`` on), a softmax, then the product with v; the result in q's
    dtype. With ``return_lse`` it returns ``(out, lse)``, lse the (BH, Sq)
    float32 logsumexp of the masked logits."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    group = bh // k.shape[0]
    kf = torch.repeat_interleave(k, group, dim=0).float()
    vf = torch.repeat_interleave(v, group, dim=0).float()
    logits = torch.einsum("hqd,hkd->hqk", q.float(), kf) / (d ** 0.5)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    kv_pos = torch.arange(skv, device=q.device)[None, :]
    mask = kv_pos < (skv if kv_len is None else kv_len)
    if causal:
        mask = mask & (q_pos >= kv_pos)
    if window is not None:
        mask = mask & ((q_pos - kv_pos) < window)
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("hqk,hkd->hqd", p, vf).to(q.dtype)
    return (out, torch.logsumexp(logits, dim=-1)) if return_lse else out


def _checked(q, k, v, block_q, block_kv, causal, window, kv_len) -> tuple:
    """Validate a call; returns (plan, kv_len). Shapes only, so it holds
    for fake tensors too."""
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 \
            or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention takes q (BH, Sq, D) and k, v "
                         f"(BH_kv, Skv, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes float32 or bf16 tensors of "
                         f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    bh, sq, d = q.shape
    bh_kv, skv = k.shape[:2]
    kv_len = skv if kv_len is None else kv_len
    if block_q < 1 or block_kv < 1:
        raise ValueError(f"tiles must be positive, got {block_q}x{block_kv}")
    # the reference's asserts (flash_attention.py:95-97), kept under -O
    if bh % bh_kv or sq % block_q or skv % block_kv:
        raise AssertionError(f"{bh} q heads over {bh_kv} kv heads, {sq} "
                             f"queries and {skv} keys in tiles of "
                             f"{block_q}x{block_kv}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    if not 1 <= kv_len <= skv:
        raise ValueError(f"kv_len must lie in 1..{skv}, got {kv_len}")
    if (causal or window is not None) and sq != skv:
        raise ValueError(f"a causal or window mask needs as many queries as "
                         f"keys, got {sq} and {skv}")
    pl = plan(block_q, block_kv, sq, d, q.dtype, skv)
    if pl is None:
        raise ConfigRejected(f"tiling ({block_q},{block_kv}) with d={d} does "
                             f"not fit csrc/flash_attention.cu")
    if not q.device == k.device == v.device:
        raise ValueError("flash_attention operands lie on different devices")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on CUDA or the CPU, not "
                         f"{q.device}")
    return pl, kv_len


def _run(q, k, v, pl: Plan, block_q: int, block_kv: int, causal: bool,
         window, return_lse: bool, kv_len: int):
    """A checked call: the kernel for tensors on the card, ``attention_plain``
    for tensors on the CPU."""
    global launches
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               return_lse=return_lse, kv_len=kv_len)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous tensors")
    bh, sq, d = q.shape
    bh_kv, skv = k.shape[:2]
    lib = _lib()
    out = torch.empty_like(q)
    lse = (torch.empty((bh, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    rc = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), bh, sq, skv, kv_len, d,
        bh // bh_kv, block_q, block_kv, int(causal),
        -1 if window is None else window,
        1.0 / (d ** 0.5), int(pl.bf16), pl.d_max, pl.threads, pl.sub_kv,
        cuda.stream_handle(q.device))
    cuda.check_launch(lib, rc, "flash_attention")
    launches += 1
    return (out, lse) if return_lse else out


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              block_q: int, block_kv: int, causal: bool, window: int,
              return_lse: bool, kv_len: int) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """The checked call as an operator PyTorch can trace: ``window`` -1 is
    none; the lse is an empty tensor unless ``return_lse``."""
    pl = plan(block_q, block_kv, q.shape[1], q.shape[2], q.dtype, k.shape[1])
    got = _run(q, k, v, pl, block_q, block_kv, causal,
               None if window < 0 else window, return_lse, kv_len)
    if return_lse:
        return got
    return got, q.new_empty((0,), dtype=torch.float32)


@_flash_op.register_fake
def _(q, k, v, block_q, block_kv, causal, window, return_lse, kv_len):
    lse_shape = q.shape[:2] if return_lse else (0,)
    return torch.empty_like(q), q.new_empty(lse_shape, dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, block_q, block_kv, causal,
                 window, return_lse, kv_len, *args, out_shape=None,
                 **kwargs) -> int:
    """``workload().flops`` of the call: 4·BH·Sq·kv_len·d, halved under a
    causal mask."""
    bh, sq, d = q_shape
    return int(workload(bh, sq, d, causal).flops({}) * kv_len // sq)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    block_q: int = 128, block_kv: int = 128,
                    causal: bool = True, window: int | None = None,
                    return_lse: bool = False, kv_len: int | None = None):
    """q: (BH, Sq, D); k/v: (BH_kv, Skv, D) with BH % BH_kv == 0 (GQA: q
    head h reads kv head h // (BH / BH_kv)), float32 or bf16, the
    reference's layout. Keys from ``kv_len`` (1 <= kv_len <= Skv, default
    Skv) on are masked as a pad; a causal or window mask needs Sq == Skv.
    The CUDA kernel for tensors on the card, launched as ``plan`` says, and
    ``attention_plain`` for tensors on the CPU, both through the operator
    ``torch.ops.repro_torch.flash_attention``, so that fake tensors get
    their shapes (``register_fake``) and a flop count
    (``register_flop_formula``) without a launch. With ``return_lse`` it
    returns ``(out, lse)``, lse the (BH, Sq) float32 logsumexp of each q
    row's masked, scaled scores. Raises ``ConfigRejected`` for a problem
    ``plan`` refuses, on either device; a plan the C side refuses raises
    ``RuntimeError`` without a launch."""
    _, kv_len = _checked(q, k, v, block_q, block_kv, causal, window, kv_len)
    out, lse = torch.ops.repro_torch.flash_attention(
        q, k, v, block_q, block_kv, causal, -1 if window is None else window,
        return_lse, kv_len)
    return (out, lse) if return_lse else out


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           block_q: int = 128, block_kv: int = 128, causal: bool = True,
           window: int | None = None, return_lse: bool = False,
           kv_len: int | None = None):
    """``flash_attention`` without the operator's dispatch: the live
    objective's call, so that no recording pays the dispatcher."""
    pl, kv_len = _checked(q, k, v, block_q, block_kv, causal, window, kv_len)
    return _run(q, k, v, pl, block_q, block_kv, causal, window, return_lse,
                kv_len)


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
        launch(q, k, v, block_q=conf["block_q"], block_kv=conf["block_kv"],
               causal=True)
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

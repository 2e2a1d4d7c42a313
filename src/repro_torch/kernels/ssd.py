"""Mamba2 SSD (state-space duality) chunked scan.

Port of ``src/repro/kernels/ssd.py``. The Pallas TPU kernel
``_ssd_kernel``/``ssd_scan`` becomes the hand-written CUDA kernel
``csrc/ssd.cu`` (its header says what bounds it on the H100 and how a
chunk larger than shared memory is walked); ``ssd_scan`` here is its
wrapper and ``ssd_plain`` the same function in plain PyTorch: the chunked
algorithm of ``_ssd_kernel`` in torch ops, chunk by chunk with the carried
(N, P) state, batched over the BH rows. The search space, the problem
sizes and the cost-model ``workload()`` are the reference's, unchanged, so
config ids agree across the two packages.

``chunk`` is a runtime argument of one compiled kernel; ``state_block``
and ``acc_dtype`` stay cost-model-only, as in the reference's
``make_live``. A problem the kernel cannot run (``fits`` is false: a state
larger than 128, or a chunk whose staging exceeds shared memory) raises
``ConfigRejected`` before any launch, on the CPU as on the card.
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

# Recording problem size (CPU interpret-mode live tuning)
SMOKE_PROBLEM = {"bh": 4, "seq": 256, "p": 32, "n": 32}

# limits of csrc/ssd.cu (checked against the library when it loads)
MAX_N = 128                # state size the shared-memory staging holds
FIXED_SMEM_FLOATS = 34048  # staging besides the chunk's cum and dt
MAX_SMEM = 232448          # dynamic shared memory of a block, bytes

# kernel launches by ``ssd_scan`` (plain-version calls on the CPU do not
# count)
launches = 0


# ----------------------------------------------------------------- kernel
def fits(config: Mapping, problem: Mapping | None = None) -> bool:
    """Whether csrc/ssd.cu can run this chunk for ``problem`` (default: the
    smoke size): a state of at most ``MAX_N`` and a chunk whose cum and dt
    fit in shared memory beside the fixed staging. Any chunk up to 12,032
    steps runs: the block walks it in 64-step sub-tiles."""
    p = {**SMOKE_PROBLEM, **(problem or {})}
    smem = (FIXED_SMEM_FLOATS + 2 * config["chunk"]) * 4
    return 1 <= p["n"] <= MAX_N and smem <= MAX_SMEM


def _lib() -> ctypes.CDLL:
    lib = cuda.library("ssd")
    if lib.repro_ssd_scan.argtypes is None:
        got = [ctypes.c_int() for _ in range(3)]
        lib.repro_ssd_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
        lib.repro_ssd_limits.restype = None
        lib.repro_ssd_limits(*(ctypes.byref(x) for x in got))
        want = (MAX_N, FIXED_SMEM_FLOATS, MAX_SMEM)
        if tuple(x.value for x in got) != want:
            raise RuntimeError(f"csrc/ssd.cu limits "
                               f"{tuple(x.value for x in got)} disagree "
                               f"with the wrapper's {want}")
        lib.repro_ssd_scan.restype = ctypes.c_int
        lib.repro_ssd_scan.argtypes = ([ctypes.c_void_p] * 6
                                       + [ctypes.c_int] * 5
                                       + [ctypes.c_void_p])
    return lib


def ssd_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor, *,
              chunk: int = 128) -> torch.Tensor:
    """The same function in plain PyTorch: ``_ssd_kernel``'s chunked
    algorithm for all BH rows at once, chunk after chunk with the float32
    state carried from one to the next (zero at chunk 0)."""
    bh, l, p = x.shape
    n = b.shape[-1]
    xf, dtf, af, bf, cf = (t.float() for t in (x, dt, a, b, c))
    h = torch.zeros((bh, n, p), dtype=torch.float32, device=x.device)
    idx = torch.arange(chunk, device=x.device)
    mask = idx[:, None] >= idx[None, :]
    ys = []
    for t0 in range(0, l, chunk):
        xc, dtc = xf[:, t0:t0 + chunk], dtf[:, t0:t0 + chunk]
        bc, cc = bf[:, t0:t0 + chunk], cf[:, t0:t0 + chunk]
        cum = torch.cumsum(dtc * af[:, None], dim=1)           # (BH, Q)
        li = cum[:, :, None] - cum[:, None, :]
        decay = torch.where(mask, torch.exp(li), 0.0)
        cb = cc @ bc.transpose(1, 2)                           # (BH, Q, Q)
        w = cb * decay * dtc[:, None, :]
        y_intra = w @ xc
        y_inter = torch.exp(cum)[:, :, None] * (cc @ h)
        ys.append(y_intra + y_inter)
        total = cum[:, -1]
        suffix = torch.exp(total[:, None] - cum) * dtc          # (BH, Q)
        bx = (bc * suffix[:, :, None]).transpose(1, 2) @ xc     # (BH, N, P)
        h = torch.exp(total)[:, None, None] * h + bx
    return torch.cat(ys, dim=1).to(x.dtype)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *,
             chunk: int = 128) -> torch.Tensor:
    """SSD scan for a flattened (batch·heads) leading dim, float32, the
    reference's layout: x (BH, L, P); dt (BH, L); a (BH,); b/c (BH, L, N).
    Returns y like x: the CUDA kernel for tensors on the card,
    ``ssd_plain`` for tensors on the CPU. Raises ``ConfigRejected`` for a
    problem ``fits`` refuses, on either device."""
    global launches
    bh, l, p = x.shape
    n = b.shape[-1]
    if dt.shape != (bh, l) or a.shape != (bh,) or b.shape != (bh, l, n) \
            or c.shape != b.shape:
        raise ValueError(f"ssd_scan takes x (BH, L, P), dt (BH, L), a (BH,), "
                         f"b and c (BH, L, N), got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    if any(t.dtype != torch.float32 for t in (x, dt, a, b, c)):
        raise ValueError("ssd_scan takes float32 tensors")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if l % chunk:  # the reference's assert (ssd.py:92), kept under -O
        raise AssertionError(f"chunk {chunk} does not divide L={l}")
    if not fits({"chunk": chunk}, {"n": n}):
        raise ConfigRejected(f"chunk {chunk} with n={n} does not fit "
                             f"csrc/ssd.cu")
    if len({t.device for t in (x, dt, a, b, c)}) != 1:
        raise ValueError("ssd_scan operands lie on different devices")
    if x.device.type == "cpu":
        return ssd_plain(x, dt, a, b, c, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on CUDA or the CPU, not {x.device}")
    if not all(t.is_contiguous() for t in (x, dt, a, b, c)):
        raise ValueError("ssd_scan takes contiguous tensors")
    lib = _lib()
    y = torch.empty_like(x)
    rc = lib.repro_ssd_scan(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                            b.data_ptr(), c.data_ptr(), y.data_ptr(), bh, l,
                            p, n, chunk, cuda.stream_handle(x.device))
    cuda.check_launch(lib, rc, "ssd_scan")
    launches += 1
    return y


# ----------------------------------------------------------- live recording
def live_inputs(problem: Mapping | None = None, device: str | None = None):
    """``(x, dt, a, b, c)``: float32 inputs of ``problem`` (default: the
    smoke size) on ``device`` (the card unless ``"cpu"`` is asked for),
    drawn from a ``torch.Generator`` seeded by ``problem["seed"]`` with the
    reference's distributions (x, b, c standard normal, dt ~ U(0.001, 0.1),
    a ~ -U(0.5, 1.5))."""
    p = {**SMOKE_PROBLEM, **(problem or {})}
    dev = cuda.resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(p.get("seed", 9))
    bh, l = p["bh"], p["seq"]

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def uniform(lo, hi, *shape):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    x = normal(bh, l, p["p"])
    dt = uniform(0.001, 0.1, bh, l)
    a = -uniform(0.5, 1.5, bh)
    b = normal(bh, l, p["n"])
    c = normal(bh, l, p["n"])
    return x, dt, a, b, c


def make_live(problem: Mapping | None = None, device: str | None = None):
    """``fn(config_dict)`` for the recorder: the chunked SSD scan on the
    fixed inputs of ``live_inputs(problem, device)``; ``fn`` runs
    ``ssd_scan`` with that chunk and, on the card, waits for it. The kernel
    library is built here, before any evaluation. The state_block and
    accumulator-dtype tunables are cost-model-only."""
    dev = cuda.resolve_device(device)
    on_card = dev != "cpu"
    if on_card:
        _lib()
    args = live_inputs(problem, dev)

    def fn(conf: Mapping) -> None:
        ssd_scan(*args, chunk=conf["chunk"])
        if on_card:
            torch.cuda.synchronize(dev)

    return fn


# ------------------------------------------------------------ search space
def space(seq: int = 4096) -> SearchSpace:
    tunables = tunables_from_dict({
        "chunk": (32, 64, 128, 256, 512),
        "acc_dtype": ("f32", "bf16"),
        "state_block": (32, 64, 128),
    })
    constraints = (
        Constraint(lambda c: seq % c["chunk"] == 0, "chunk divides L"),
        Constraint(lambda c: c["state_block"] <= 128, "state fits a tile"),
    )
    return SearchSpace(tunables, constraints, name="ssd")


# -------------------------------------------------------------- cost model
def workload(bh: int = 24 * 8, seq: int = 4096, p: int = 64,
             n: int = 128) -> KernelWorkload:
    def flops(c: Mapping) -> float:
        q = c["chunk"]
        per_chunk = 2 * q * q * n + 2 * q * q * p + 4 * q * n * p
        return bh * (seq // q) * per_chunk

    def hbm_bytes(c: Mapping, dev: DeviceModel) -> float:
        return bh * seq * (p + 2 * n + 1) * 2 * 2  # in+out streams, bf16

    def vmem_bytes(c: Mapping) -> float:
        q = c["chunk"]
        acc = 4 if c["acc_dtype"] == "f32" else 2
        return (2 * (q * p + 2 * q * n + q) * 2 + q * q * acc + n * p * 4
                + q * p * acc)

    def grid_size(c: Mapping) -> float:
        return bh * (seq // c["chunk"])

    def compute_eff(c: Mapping, dev: DeviceModel) -> float:
        q = c["chunk"]
        eff = alignment_eff(q, dev.mxu) * alignment_eff(n, dev.lane)
        eff *= min(1.0, q / dev.mxu) ** 0.5
        if c["acc_dtype"] == "bf16":
            eff *= 0.93
        eff *= {32: 0.9, 64: 1.0, 128: 1.0}[c["state_block"]]
        return 0.7 * eff  # cumsum/exp VPU work between matmuls

    return KernelWorkload("ssd", flops, hbm_bytes, vmem_bytes, grid_size,
                          compute_eff)


def needed_flops(bh: int = 24 * 8, seq: int = 4096, p: int = 64,
                 n: int = 128) -> float:
    """Operations the scan needs whatever its chunking: each step's state
    update and readout, an (N, P) multiply-add each (an FMA is 2), so
    4·bh·L·N·P. The step-by-step recurrence adds a decay of the state each
    step; a chunk of Q steps decays it once but adds its intra-chunk
    Q x Q terms (which ``workload``'s cost model counts whole), so neither
    needs less. A bound on the card's time rests on this count."""
    return 4.0 * bh * seq * n * p

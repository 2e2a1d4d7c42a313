"""Mamba2 SSD (state-space duality) chunked scan.

Port of ``src/repro/kernels/ssd.py``. The Pallas TPU kernel
``_ssd_kernel``/``ssd_scan`` becomes three hand-written CUDA kernels in
``csrc/ssd.cu``, the chunk-parallel form of the same algebra (its header
says what bounds it on the H100 and what the design does about it): chunk
states, a state pass over the chunks, chunk outputs. ``ssd_scan`` here is
their wrapper and ``ssd_plain`` the same three passes in batched PyTorch.
Both can also return the state after the last step (``final_state``),
which the Pallas kernel keeps in VMEM scratch and the reference model's
``_ssd_chunked`` returns for the decode cache; the state pass writes it.
The search space, the problem sizes and the cost-model ``workload()`` are
the reference's, unchanged, so config ids agree across the two packages.

``chunk`` is a runtime argument of the compiled kernels; ``state_block``
and ``acc_dtype`` stay cost-model-only, as in the reference's
``make_live``. A problem the kernels cannot run (``fits`` is false: a
state larger than ``MAX_N`` = 256) raises ``ConfigRejected`` before any
launch, on the CPU as on the card. A chunk of any length runs: its cum
goes through device memory, not shared memory.

``ssd_scan`` goes through the operator ``torch.ops.repro_torch.ssd_scan``
(``torch.library.custom_op``): its implementation is the three launches
(the plain version on the CPU), its fake implementation the output
shapes, its flop formula ``chunked_flops``, so the dry run traces models
through it. ``launches`` counts as before; ``launch`` (``make_live``'s
recordings) and a call with ``marks`` skip the dispatcher.
"""
from __future__ import annotations

import ctypes
from typing import Mapping, Sequence

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import cuda
from ..core.costmodel import KernelWorkload, alignment_eff
from ..core.devices import DeviceModel
from ..core.searchspace import SearchSpace
from ..core.tunable import Constraint, tunables_from_dict

ConfigRejected = cuda.ConfigRejected

# Recording problem size (CPU interpret-mode live tuning)
SMOKE_PROBLEM = {"bh": 4, "seq": 256, "p": 32, "n": 32}

# limits of csrc/ssd.cu (checked against the library when it loads): the
# state size whose C sub-tile pass 3 keeps in shared memory, the steps of a
# pass-3 sub-tile, the columns of x, y and h a block owns
MAX_N = 256
SUB_ROWS = 64
SLICE_P = 64
PASSES = ("repro_ssd_chunk_states", "repro_ssd_state_pass",
          "repro_ssd_chunk_outputs")

# ``ssd_scan`` calls on the card: each is one launch of each of the three
# kernels (plain-version calls on the CPU do not count)
launches = 0


# ----------------------------------------------------------------- kernel
def fits(config: Mapping, problem: Mapping | None = None) -> bool:
    """Whether csrc/ssd.cu can run this chunk for ``problem`` (default: the
    smoke size): a positive chunk and a state of at most ``MAX_N``."""
    p = {**SMOKE_PROBLEM, **(problem or {})}
    return config["chunk"] >= 1 and 1 <= p["n"] <= MAX_N


def _lib() -> ctypes.CDLL:
    lib = cuda.library("ssd")
    if lib.repro_ssd_chunk_outputs.argtypes is None:
        got = [ctypes.c_int() for _ in range(3)]
        lib.repro_ssd_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
        lib.repro_ssd_limits.restype = None
        lib.repro_ssd_limits(*(ctypes.byref(x) for x in got))
        want = (MAX_N, SUB_ROWS, SLICE_P)
        if tuple(x.value for x in got) != want:
            raise RuntimeError(f"csrc/ssd.cu limits "
                               f"{tuple(x.value for x in got)} disagree "
                               f"with the wrapper's {want}")
        # pointers, then bh, l, p, n, chunk (pass 1 also with_last), then
        # the stream
        args = {"repro_ssd_chunk_states": (6, 6),
                "repro_ssd_state_pass": (3, 5),
                "repro_ssd_chunk_outputs": (7, 5)}
        for name in PASSES:
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            pointers, ints = args[name]
            fn.argtypes = ([ctypes.c_void_p] * pointers
                           + [ctypes.c_int] * ints + [ctypes.c_void_p])
    return lib


def ssd_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128,
              final_state: bool = False, chunk_states: bool = False):
    """The same function in plain PyTorch, as the kernels' three passes
    over all BH rows and chunks at once: each chunk's cum and state
    ``S_c = (B o exp(total_c - cum) dt)^T X``; the one loop, over chunks,
    ``h_{c+1} = exp(total_c) h_c + S_c`` from zero; then every chunk's
    intra-chunk term ``((C B^T) o exp(cum_i - cum_j)[j <= i] o dt_j) X``
    (``torch.where`` keeps the overflowing upper triangle out of the
    values and of autograd's gradients) and
    inter-chunk term ``exp(cum) C h_c``. With ``final_state`` it returns
    ``(y, h)``, h the (BH, N, P) float32 state after the last chunk; with
    ``chunk_states`` also (last) the (BH, L / chunk, N, P) float32 states
    h_c that enter each chunk."""
    bh, l, p = x.shape
    n = b.shape[-1]
    nc = l // chunk
    xc, bc, cc = (t.float().reshape(bh, nc, chunk, -1) for t in (x, b, c))
    dtc = dt.float().reshape(bh, nc, chunk)
    cum = torch.cumsum(dtc * a.float()[:, None, None], dim=2)   # (BH, C, Q)
    total = cum[..., -1]                                        # (BH, C)
    w = torch.exp(total[..., None] - cum) * dtc
    states = (bc * w[..., None]).transpose(-1, -2) @ xc         # (BH,C,N,P)
    decay = torch.exp(total)
    h = torch.zeros((bh, n, p), dtype=torch.float32, device=x.device)
    h_in = []
    for ci in range(nc):
        h_in.append(h)
        h = decay[:, ci, None, None] * h + states[:, ci]
    idx = torch.arange(chunk, device=x.device)
    mask = idx[:, None] >= idx[None, :]
    li = cum[..., :, None] - cum[..., None, :]                  # (BH,C,Q,Q)
    # the exponent is zeroed above the diagonal before the exp, so that
    # autograd through this version meets no inf x 0 (the values are the
    # same)
    weights = (cc @ bc.transpose(-1, -2)) * torch.where(
        mask, torch.exp(torch.where(mask, li, 0.0)), 0.0) * dtc[..., None, :]
    h_in = torch.stack(h_in, 1)
    y = weights @ xc + torch.exp(cum)[..., None] * (cc @ h_in)
    y = y.reshape(bh, l, p).to(x.dtype)
    return _outputs(y, h if final_state else None,
                    h_in if chunk_states else None)


def _outputs(y, h, states):
    """``y``, or a tuple of y and the outputs asked for."""
    extra = tuple(t for t in (h, states) if t is not None)
    return (y, *extra) if extra else y


def _checked(x, dt, a, b, c, chunk: int) -> None:
    """Validate a call (shapes only, so it holds for fake tensors too)."""
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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan runs on CUDA or the CPU, not {x.device}")


def _run(x, dt, a, b, c, chunk: int, final_state: bool, chunk_states: bool,
         marks=None):
    """A checked call: the three kernels for tensors on the card,
    ``ssd_plain`` for tensors on the CPU."""
    global launches
    if x.device.type == "cpu":
        return ssd_plain(x, dt, a, b, c, chunk=chunk, final_state=final_state,
                         chunk_states=chunk_states)
    if not all(t.is_contiguous() for t in (x, dt, a, b, c)):
        raise ValueError("ssd_scan takes contiguous tensors")
    bh, l, p = x.shape
    n = b.shape[-1]
    lib = _lib()
    y = torch.empty_like(x)
    cum = torch.empty((bh, l), dtype=torch.float32, device=x.device)
    states = torch.empty((bh, l // chunk, n, p), dtype=torch.float32,
                         device=x.device)
    h = (torch.empty((bh, n, p), dtype=torch.float32, device=x.device)
         if final_state else None)
    shape = (bh, l, p, n, chunk)
    calls = (((x, dt, a, b, cum, states), (*shape, int(final_state))),
             ((cum, states, h), shape), ((x, dt, b, c, cum, states, y), shape))
    stream = cuda.stream_handle(x.device)
    if marks:
        marks[0].record()
    for i, (name, (ptrs, ints)) in enumerate(zip(PASSES, calls)):
        rc = getattr(lib, name)(
            *(None if t is None else t.data_ptr() for t in ptrs), *ints,
            stream)
        cuda.check_launch(lib, rc, f"ssd_scan ({name})")
        if marks:
            marks[i + 1].record()
    launches += 1
    return _outputs(y, h, states if chunk_states else None)


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=())
def _ssd_op(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor, chunk: int, final_state: bool,
            chunk_states: bool) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The checked call as an operator PyTorch can trace: (y, h, states),
    h and states empty tensors unless asked for."""
    got = _run(x, dt, a, b, c, chunk, final_state, chunk_states)
    got = got if isinstance(got, tuple) else (got,)
    y, rest = got[0], list(got[1:])
    empty = x.new_empty((0,))
    h = rest.pop(0) if final_state else empty
    states = rest.pop(0) if chunk_states else empty.clone()
    return y, h, states


@_ssd_op.register_fake
def _(x, dt, a, b, c, chunk, final_state, chunk_states):
    bh, l, p = x.shape
    n = b.shape[-1]
    h = x.new_empty((bh, n, p) if final_state else (0,))
    states = x.new_empty((bh, l // chunk, n, p) if chunk_states else (0,))
    return torch.empty_like(x), h, states


@register_flop_formula(torch.ops.repro_torch.ssd_scan)
def _ssd_flops(x_shape, dt_shape, a_shape, b_shape, c_shape, chunk,
               *args, out_shape=None, **kwargs) -> int:
    """``chunked_flops`` of the call."""
    bh, l, p = x_shape
    return int(chunked_flops(bh, l, p, b_shape[-1], chunk))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128,
             final_state: bool = False, chunk_states: bool = False,
             marks: Sequence | None = None):
    """SSD scan for a flattened (batch·heads) leading dim, float32, the
    reference's layout: x (BH, L, P); dt (BH, L); a (BH,); b/c (BH, L, N).
    Returns y like x, or ``(y, h)`` with ``final_state``, h the (BH, N, P)
    float32 state after the last step (pass 1 then also computes the last
    chunk's state, and the state pass writes h); with ``chunk_states``
    also (last) the (BH, L / chunk, N, P) float32 states h_c that enter
    each chunk, the backward's input: the state scratch, which the state
    pass leaves holding them, returned instead of freed (no launch more,
    y unchanged). The three CUDA kernels for tensors on the card (a (BH,
    L) cum and a (BH, L / chunk, N, P) state scratch allocated here),
    ``ssd_plain`` for tensors on the CPU, both through the operator
    ``torch.ops.repro_torch.ssd_scan`` (fake tensors get their shapes and
    ``chunked_flops`` without a launch).
    Raises ``ConfigRejected`` for a problem ``fits`` refuses, on either
    device. ``marks``, four CUDA events, are recorded before the first
    kernel and after each (so a caller can time the passes); a call with
    marks launches without the operator's dispatch."""
    _checked(x, dt, a, b, c, chunk)
    if marks:
        return _run(x, dt, a, b, c, chunk, final_state, chunk_states, marks)
    y, h, states = torch.ops.repro_torch.ssd_scan(x, dt, a, b, c, chunk,
                                                  final_state, chunk_states)
    return _outputs(y, h if final_state else None,
                    states if chunk_states else None)


def launch(x, dt, a, b, c, *, chunk: int = 128, final_state: bool = False,
           chunk_states: bool = False):
    """``ssd_scan`` without the operator's dispatch: the live objective's
    call, so that no recording pays the dispatcher."""
    _checked(x, dt, a, b, c, chunk)
    return _run(x, dt, a, b, c, chunk, final_state, chunk_states)


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
        launch(*args, chunk=conf["chunk"])
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


def chunked_flops(bh: int = 24 * 8, seq: int = 4096, p: int = 64,
                  n: int = 128, chunk: int = 128) -> float:
    """Operations of the chunked algorithm as csrc/ssd.cu runs it, an FMA
    being 2: the state products of passes 1 and 3 (``needed_flops``) and,
    per chunk, the intra-chunk products C B^T (depth N) and W X (depth P)
    over the pairs of sub-tiles of min(``SUB_ROWS``, chunk) steps on or
    below the diagonal. Over the card's rate it gives the algorithm floor
    beside the operations bound."""
    rows = min(SUB_ROWS, chunk)
    subs = -(-chunk // rows)
    pairs = subs * (subs + 1) // 2
    intra = bh * (seq // chunk) * pairs * 2.0 * rows * rows * (n + p)
    return needed_flops(bh, seq, p, n) + intra

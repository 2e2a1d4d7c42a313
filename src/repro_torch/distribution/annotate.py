"""Logical sharding annotations for model internals.

Port of ``src/repro/distribution/annotate.py``. The reference pins the
layout at a few points of the model with ``with_sharding_constraint``, in
*logical* axes resolved against an ambient (mesh, layout):

  logical "dp"  — the batch axis of activations
  logical "tp"  — the tensor-parallel axis (heads / ffn / experts)
  logical "sp"  — the sequence axis of the residual stream

Layout policies (the §Perf tunable):
  "2d"      baseline: dp=(pod,data), tp=model, sp unsharded — Megatron-style
            TP with activation all-reduces.
  "dp"      pure data parallel: dp=(pod,data,model) — all ranks shard the
            batch, no tensor parallelism of activations (params stay 2D
            FSDP-sharded and are all-gathered where they are used).
  "2d_seq"  sequence parallelism: like 2d but the residual stream is
            sequence-sharded on the model axis between blocks.

``annotation_mesh(mesh, layout)`` installs the context (the dry run and
phase 12 of ``chip_smoke.py`` do); without one every ``annotate`` is a
no-op, one thread-local read. A dim is only sharded when the axis size
divides it.

What changed: the mesh is a ``DeviceMesh`` and ``annotate`` redistributes
a DTensor to the resolved placements (free when they already hold, and
shown in ``CommDebugMode`` when they do not), where the reference's
constraint lets GSPMD choose how to get there; as the constraint does,
it pins the gradient to the same placements in the backward (``_Pin``).
``residual`` pins a sublayer's output for its residual add, with
distinct placements forward and backward under 2d_seq. A plain tensor
passes through unchanged, mesh or not: only DTensors carry a layout.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import threading

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                     distribute_tensor)
from torch.distributed.tensor.experimental import local_map

from .sharding import axes_of, placements

_STATE = threading.local()
LAYOUTS = ("2d", "dp", "2d_seq")


def _current():
    return getattr(_STATE, "mesh", None), getattr(_STATE, "layout", "2d")


@contextlib.contextmanager
def _installed(mesh, layout: str, rows):
    prev = (*_current(), getattr(_STATE, "rows", None))
    _STATE.mesh, _STATE.layout, _STATE.rows = mesh, layout, rows
    try:
        yield
    finally:
        _STATE.mesh, _STATE.layout, _STATE.rows = prev


def annotation_mesh(mesh, layout: str = "2d"):
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, not {layout!r}")
    return _installed(mesh, layout, None)


def batch_rows(n: int):
    """A context in which the activations' batch axis ("dp") is laid out
    for a batch of ``n`` rows: where the installed layout's batch axes do
    not divide ``n``, on the widest of their sub-tuples that does (in
    mesh order; none if none does), so that each rank keeps its own rows
    where the reference's GSPMD would, rather than every rank computing
    them all. The layout's own axes where they divide; nothing without a
    mesh. The train step enters it for each (micro)batch."""
    mesh, layout = _current()
    if mesh is None:
        return _installed(None, layout, None)
    ax = axes_of(mesh)
    dp = _resolve(ax.names, layout, "dp")
    subs = [c for k in range(len(dp), 0, -1)
            for c in itertools.combinations(dp, k)]
    fits = [c for c in subs if n % math.prod(ax.shape[a] for a in c) == 0]
    rows = max(fits, key=lambda c: math.prod(ax.shape[a] for a in c),
               default=())
    return _installed(mesh, layout, rows)


def _resolve(names, layout: str, logical: str | None):
    if logical is None:
        return None
    if logical == "dp":
        if layout == "dp":
            return tuple(a for a in names if a in ("pod", "data", "model"))
        return tuple(a for a in names if a in ("pod", "data"))
    if logical == "tp":
        if layout == "dp":
            return None
        return "model" if "model" in names else None
    if logical == "sp":
        if layout == "2d_seq" and "model" in names:
            return "model"
        return None
    raise ValueError(logical)


def resolve_spec(mesh, layout: str, shape, *logical_spec) -> tuple:
    """The spec ``annotate`` pins a tensor of ``shape`` to: each logical
    axis resolved ("dp" as ``batch_rows`` lays it out, where entered),
    and dropped where its size does not divide the dim."""
    ax = axes_of(mesh)
    names, sizes = ax.names, ax.shape
    rows = getattr(_STATE, "rows", None)
    spec = []
    for dim, logical in zip(shape, logical_spec):
        axes = _resolve(names, layout, logical)
        if logical == "dp" and rows is not None:
            axes = rows or None
        if axes is None:
            spec.append(None)
            continue
        size = 1
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            size *= sizes[a]
        spec.append(axes if dim % size == 0 else None)
    spec += [None] * (len(shape) - len(spec))
    return tuple(spec)


class _Pin(torch.autograd.Function):
    """``with_sharding_constraint``'s semantics: the value is laid out as
    ``want``, and so is its gradient (DTensor's own ``redistribute``
    sends the gradient back in the input's layout, which lets a
    replicated gradient run the backward's products unsharded), or as
    ``grad_want`` where given."""

    @staticmethod
    def forward(ctx, x, want, grad_want=None):
        ctx.want = want if grad_want is None else grad_want
        if tuple(x.placements) == want:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, grad):
        if isinstance(grad, DTensor) and tuple(grad.placements) != ctx.want:
            grad = grad.redistribute(grad.device_mesh, ctx.want)
        return grad, None, None


def annotate(x, *logical_spec):
    """``x`` pinned to its logical layout, forward and backward (a DTensor
    under an installed mesh); ``x`` itself otherwise."""
    mesh = getattr(_STATE, "mesh", None)
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = resolve_spec(mesh, _STATE.layout, x.shape, *logical_spec)
    return _Pin.apply(x, placements(mesh, spec))


def residual(h):
    """A sublayer's output (B, S, D) laid out as the residual stream it is
    added to, ("dp", "sp", None): under sequence parallelism (2d_seq) a
    partial sum over the model axis is reduce-scattered into the
    stream's sequence shard, as GSPMD does, where pinning it whole would
    all-reduce it and the add then slice it. Its gradient is pinned whole
    in its sequence, ("dp", None, None): the backward gathers it before
    the sublayer's products, which DTensor cannot run on a sequence
    shard folded into their rows. Under the other layouts both are
    ("dp", None, None), as ``annotate`` pins; ``h`` itself without a
    mesh or a DTensor."""
    mesh = getattr(_STATE, "mesh", None)
    if mesh is None or not isinstance(h, DTensor):
        return h
    layout = _STATE.layout
    want = placements(mesh, resolve_spec(mesh, layout, h.shape, "dp", "sp",
                                         None))
    whole = placements(mesh, resolve_spec(mesh, layout, h.shape, "dp", None,
                                          None))
    return _Pin.apply(h, want, whole)


def gathered(w, x=None):
    """A parameter as a product with ``x`` uses it. A DTensor is
    gathered on the axes that shard the activations' batch under the
    installed layout ("pod" and "data"; all three under ``dp``; the FSDP
    axes without a mesh) where they shard x's rows too, as the
    reference's GSPMD all-gathers an FSDP shard where the activations
    keep their batch shard, decode steps included: DTensor's own choice
    may instead contract over that shard and replicate the batch on its
    axis, so that every rank computes and holds every row of the product
    (and its einsum over the MoE's expert weights fails in the backward).
    Outside a backward (serving), on an axis that does not split x (a
    batch of one) the shard stays and the ranks split the contraction
    over it, as XLA does; a backward through such a product meets a
    strided shard DTensor cannot propagate, so with gradients the shard
    is always gathered. The gradient is laid out as the parameter is.
    Mesh dims of one rank are left alone; ``w`` itself when it is not a
    DTensor or nothing moves."""
    if not isinstance(w, DTensor):
        return w
    mesh = w.device_mesh
    names = mesh.mesh_dim_names
    installed, layout = _current()
    dp = _resolve(names, layout if installed is not None else "2d", "dp")
    split = (range(mesh.ndim)
             if not isinstance(x, DTensor)
             or (torch.is_grad_enabled() and w.requires_grad) else
             [i for i, p in enumerate(x.placements) if isinstance(p, Shard)])
    have = tuple(w.placements)
    want = tuple(Replicate() if names[i] in dp and mesh.size(i) > 1
                 and i in split else p for i, p in enumerate(have))
    if want == have:
        return w
    return _Pin.apply(w, want, have)


def matmul_tp(x, w):
    """``x @ w`` in x's dtype for x (..., D) and a gathered weight w (D,
    V), cast where it is used. Where the tensor-parallel axis shards
    neither (a width it does not divide, as the unembedding of a
    50,280-token vocab on 16 ranks), the ranks of that axis split the
    contraction D, each casting and multiplying its slice
    (``summed_map``), and the partial sums are added where the product
    is next used, as XLA splits such a product; DTensor would run it
    whole on every rank of the axis. Otherwise ``x @ w`` (w cast to x's
    dtype where it differs)."""
    mesh, layout = _current()
    if mesh is None or not (isinstance(x, DTensor)
                            and isinstance(w, DTensor)):
        return x @ _cast(w, x.dtype)
    names = w.device_mesh.mesh_dim_names
    tp = _resolve(names, layout, "tp")
    if tp is None:
        return x @ _cast(w, x.dtype)
    i = names.index(tp)
    n = w.device_mesh.size(i)
    if (n == 1 or w.shape[0] % n or x.placements[i] != Replicate()
            or any(p != Replicate() for p in w.placements)):
        return x @ _cast(w, x.dtype)
    xp = tuple(Shard(x.ndim - 1) if j == i else p
               for j, p in enumerate(x.placements))
    wp = tuple(Shard(0) if j == i else p for j, p in enumerate(w.placements))
    out = tuple(Partial() if j == i else p
                for j, p in enumerate(x.placements))
    w = w.redistribute(w.device_mesh, wp).to(x.dtype)
    return summed_map(torch.matmul, out_placements=list(out),
                      in_placements=(list(xp), list(wp)))(
        x.redistribute(x.device_mesh, xp), w)


def _cast(w, dtype):
    """``w`` in ``dtype``: itself where it is already, with no dispatch."""
    return w if w.dtype == dtype else w.to(dtype)


class _PartialGrad(torch.autograd.Function):
    """``x`` itself, whose gradient is declared a partial sum on the mesh
    dims ``dims`` where it arrives replicated."""

    @staticmethod
    def forward(ctx, x, dims):
        ctx.dims = dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if not isinstance(grad, DTensor):
            return grad, None
        want = tuple(Partial() if i in ctx.dims and p == Replicate() else p
                     for i, p in enumerate(grad.placements))
        return DTensor.from_local(grad.to_local(), grad.device_mesh, want,
                                  run_check=False, shape=grad.shape,
                                  stride=grad.stride()), None


def summed_map(fn, out_placements, in_placements):
    """``local_map(fn, ...)`` whose backward adds the ranks' gradients of a
    replicated input: an input replicated on a mesh dim that splits an
    output (a weight beside batch-sharded rows, kv heads beside a rank's
    q heads) gets on each rank the gradient of that rank's share alone,
    which ``local_map`` would declare the replicated whole; it is
    declared a partial sum there instead, so DTensor adds the shares."""
    outs = (out_placements if isinstance(out_placements, tuple)
            else (out_placements,))
    split = {d for pl in outs for d, p in enumerate(pl)
             if isinstance(p, Shard)}
    mapped = local_map(fn, out_placements=out_placements,
                       in_placements=in_placements)

    def call(*args):
        summed = []
        for a, pl in zip(args, in_placements):
            if isinstance(a, DTensor) and a.requires_grad:
                dims = tuple(d for d in sorted(split) if pl[d] == Replicate()
                             and a.device_mesh.size(d) > 1)
                if dims:
                    a = _PartialGrad.apply(a, dims)
            summed.append(a)
        return mapped(*summed)

    return call


def current_layout() -> str:
    return _current()[1]


def reinstall():
    """A context manager that installs the (mesh, layout, batch rows)
    installed now, to enter later: a rematerialised layer recomputes
    inside the backward, which on the card runs on autograd's device
    thread, where this thread's state is not installed."""
    return _installed(*_current(), getattr(_STATE, "rows", None))


def site_placements(x, *logical) -> tuple:
    """The placements a kernel's call site maps DTensor ``x`` to before it
    runs the kernel on each rank's shard: ``annotate``'s layout of the
    logical dims when a mesh is installed, else ``x``'s own ``Shard`` of
    those dims, every other mesh dim replicated."""
    mesh, layout = _current()
    if mesh is not None:
        return placements(mesh, resolve_spec(mesh, layout, x.shape,
                                             *logical))
    keep = {d for d, name in enumerate(logical) if name is not None}
    return tuple(p if isinstance(p, Shard) and p.dim in keep
                 else Replicate() for p in x.placements)


def split_last(x, n: int, d: int):
    """``x`` (..., n·d) viewed as (..., n, d). A DTensor sharded on its
    last dim keeps that shard only where the mesh dim's size divides
    ``n`` (whole heads a rank); elsewhere the dim is gathered first,
    explicitly, as DTensor cannot split a shard across the view."""
    if isinstance(x, DTensor):
        x = _whole_heads(x, n)
    return x.reshape(*x.shape[:-1], n, d)


def _whole_heads(x, n: int):
    """DTensor ``x`` with its last dim gathered on every mesh dim whose
    size does not divide ``n``."""
    last, mesh = x.ndim - 1, x.device_mesh
    want = tuple(Replicate() if p == Shard(last) and n % mesh.size(i)
                 else p for i, p in enumerate(x.placements))
    return x if want == tuple(x.placements) else x.redistribute(mesh, want)


def rows_like(t, ref):
    """Plain ``t``, whose leading dim is ``ref``'s batch rows, laid out as
    ``ref``'s rows when ``ref`` is a DTensor: each rank keeps its own rows
    (a local slice, no collective). Positions and step indices are made
    whole on every rank; DTensor would otherwise treat them as replicated
    beside batch-sharded activations, which it cannot always reconcile."""
    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    mesh = ref.device_mesh
    rows = tuple(p if p == Shard(0) else Replicate() for p in ref.placements)
    return distribute_tensor(t, mesh, rows, src_data_rank=None)


class _Merge(torch.autograd.Function):
    """(..., n, d) -> (..., n·d) whose backward gathers a gradient sharded
    on the merged dim where the mesh dim's size does not divide ``n``
    (DTensor cannot split such a shard back into whole heads)."""

    @staticmethod
    def forward(ctx, x, n: int):
        ctx.n, ctx.shape = n, x.shape
        return x.reshape(*x.shape[:-2], -1)

    @staticmethod
    def backward(ctx, grad):
        if isinstance(grad, DTensor):
            grad = _whole_heads(grad, ctx.n)
        return grad.reshape(ctx.shape), None


def merge_last(x):
    """``x`` (..., n, d) viewed as (..., n·d); the inverse of
    ``split_last``, for DTensors also in the backward."""
    if isinstance(x, DTensor):
        return _Merge.apply(x, x.shape[-2])
    return x.reshape(*x.shape[:-2], -1)


def pin_grad(x):
    """``x`` itself, whose gradient is laid out as ``x`` is: for a
    parameter used in more than one place (a tied embedding), so that
    its gradients add in one layout (DTensor may not turn one layout
    into the partial sum the other arrives as)."""
    if isinstance(x, DTensor) and torch.is_grad_enabled() and \
            x.requires_grad:
        return _Pin.apply(x, tuple(x.placements))
    return x

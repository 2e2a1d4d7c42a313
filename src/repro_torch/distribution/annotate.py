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
A plain tensor passes through unchanged, mesh or not: only DTensors
carry a layout.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                     distribute_tensor)

from .sharding import axes_of, placements

_STATE = threading.local()
LAYOUTS = ("2d", "dp", "2d_seq")


def _current():
    return getattr(_STATE, "mesh", None), getattr(_STATE, "layout", "2d")


@contextlib.contextmanager
def annotation_mesh(mesh, layout: str = "2d"):
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, not {layout!r}")
    prev = _current()
    _STATE.mesh, _STATE.layout = mesh, layout
    try:
        yield
    finally:
        _STATE.mesh, _STATE.layout = prev


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
    axis resolved, and dropped where its size does not divide the dim."""
    ax = axes_of(mesh)
    names, sizes = ax.names, ax.shape
    spec = []
    for dim, logical in zip(shape, logical_spec):
        axes = _resolve(names, layout, logical)
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
    replicated gradient run the backward's products unsharded)."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        if tuple(x.placements) == want:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, grad):
        if isinstance(grad, DTensor) and tuple(grad.placements) != ctx.want:
            grad = grad.redistribute(grad.device_mesh, ctx.want)
        return grad, None


def annotate(x, *logical_spec):
    """``x`` pinned to its logical layout, forward and backward (a DTensor
    under an installed mesh); ``x`` itself otherwise."""
    mesh = getattr(_STATE, "mesh", None)
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = resolve_spec(mesh, _STATE.layout, x.shape, *logical_spec)
    return _Pin.apply(x, placements(mesh, spec))


def current_layout() -> str:
    return _current()[1]


def reinstall():
    """A context manager that installs the (mesh, layout) installed now,
    to enter later: a rematerialised layer recomputes inside the
    backward, which on the card runs on autograd's device thread, where
    this thread's state is not installed."""
    return annotation_mesh(*_current())


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

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
import math
import threading

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                     distribute_tensor)

from .sharding import axes_of, placements

_STATE = threading.local()
LAYOUTS = ("2d", "dp", "2d_seq")


def _current():
    return getattr(_STATE, "mesh", None), getattr(_STATE, "layout", "2d")


@contextlib.contextmanager
def _installed(mesh, layout: str):
    prev = _current()
    _STATE.mesh, _STATE.layout = mesh, layout
    try:
        yield
    finally:
        _STATE.mesh, _STATE.layout = prev


def annotation_mesh(mesh, layout: str = "2d"):
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, not {layout!r}")
    return _installed(mesh, layout)


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


def batch_ranks() -> int:
    """The ranks the installed layout's batch axes ("dp") span: the
    multiple a train step pads each (micro)batch's rows to; 1 without a
    mesh."""
    mesh, layout = _current()
    if mesh is None:
        return 1
    shape = axes_of(mesh).shape
    return math.prod(shape[a] for a in _resolve(tuple(shape), layout, "dp"))


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


def product(x, w):
    """``x @ w`` of a weight ``w`` (D, V) in x's dtype, as the installed
    layout runs it: for DTensors outside a backward where x is the
    smaller (``_few_rows``: a decode step's unembedding) on w's shards
    (``contract_on_shards``), else on w gathered as it is used
    (``gathered``, ``matmul_tp``)."""
    if not isinstance(x, DTensor):
        return x @ w
    if _few_rows(x, w):
        return contract_on_shards(x, w)
    return matmul_tp(x, gathered(w, x))


def _few_rows(x, w) -> bool:
    """Whether the product ``x @ w`` of DTensors, outside a backward, is
    better split over ``w``'s FSDP shard than run on a gathered ``w``: x
    holds fewer elements than w (a decode step's tokens against a
    vocab-wide table) and its rows are split on a mesh dim that shards
    w's contraction dim, where ``gathered`` would gather w."""
    if torch.is_grad_enabled() or not (isinstance(x, DTensor)
                                       and isinstance(w, DTensor)):
        return False
    pl = list(zip(w.placements, x.placements))
    return (x.numel() < w.numel()
            and all(q == Replicate() for p, q in pl if p == Shard(1))
            and any(p == q == Shard(0) and w.device_mesh.size(i) > 1
                    for i, (p, q) in enumerate(pl)))


def contract_on_shards(x, w):
    """``x @ w`` for DTensor x (B, S, D) and w (D, V) where ``_few_rows``:
    w stays on its shards, as XLA leaves it. On each mesh dim that
    shards D (FSDP) x's tokens are gathered and its D split alike (an
    all-to-all of the few tokens); on the tensor-parallel dim, where w is
    whole, both split D once more where it divides, else w's V is split
    (unevenly where the dim does not divide V); each rank multiplies its
    slices, and the partial sums are reduce-scattered back to x's rows
    (all-reduced where x's rows were whole), the tensor-parallel dim's
    all-reduced or gathered. V keeps w's own shard, where x is whole."""
    mesh = w.device_mesh
    i_tp = tp_dim(mesh)
    have_x = tuple(x.placements)
    split = [i for i, p in enumerate(w.placements)
             if p == Shard(0) and mesh.size(i) > 1]
    n = math.prod(mesh.size(i) for i in split)
    vocab = None
    if i_tp is not None and w.placements[i_tp] == Replicate():
        if w.shape[0] % (n * mesh.size(i_tp)) == 0:
            split.append(i_tp)
        else:
            vocab = i_tp
    last = x.ndim - 1
    xp = tuple(Shard(last) if i in split else p for i, p in enumerate(have_x))
    wp = tuple(Shard(0) if i in split else Shard(1) if i == vocab else p
               for i, p in enumerate(w.placements))
    op = tuple(Partial() if i in split else Shard(last) if q == Shard(1)
               else p for i, (p, q) in enumerate(zip(xp, wp)))
    out = summed_map(torch.matmul, out_placements=list(op),
                     in_placements=(list(xp), list(wp)),
                     out_shapes=((*x.shape[:-1], w.shape[1]),))(
        x.redistribute(mesh, xp), w.redistribute(mesh, wp))
    back = tuple(have_x[i] if i in split and have_x[i] == Shard(0) and
                 i != i_tp else Replicate() if i in split or i == vocab
                 else p for i, p in enumerate(op))
    return out.redistribute(mesh, back)


class _ShardToRows(torch.autograd.Function):
    """A rank's slice ``x`` of its tensor dim ``dim`` (of every row) to
    the whole of that dim for its own rows, by one all-to-all on each of
    the mesh dims ``groups`` (sizes ``sizes``, outermost first) that
    split ``dim`` in that nesting: the innermost first, each sending the
    block of rows whose index on that mesh dim is j to rank j and laying
    the blocks received side by side in ``dim`` in rank order, so that
    the rows end nested as ``dim`` was. The backward runs the inverse."""

    @staticmethod
    def forward(ctx, x, dim: int, groups, sizes):
        ctx.dim, ctx.groups, ctx.sizes = dim, groups, sizes
        y = x.reshape(*sizes, x.shape[0] // math.prod(sizes), *x.shape[1:])
        for m in reversed(range(len(sizes))):
            y = y.movedim(m, 0).contiguous()
            y = waited(funcol.all_to_all_single(y, None, None, groups[m]))
            # the source rank's axis goes before ``dim`` and merges into it
            y = y.movedim(0, m + dim)
            y = y.reshape(*y.shape[:m + dim], -1, *y.shape[m + dim + 2:])
        return y

    @staticmethod
    def backward(ctx, grad):
        dim, sizes = ctx.dim, ctx.sizes
        g = grad
        for m, n in enumerate(sizes):
            g = g.reshape(*g.shape[:m + dim], n, -1, *g.shape[m + dim + 1:])
            g = waited(funcol.all_to_all_single(
                g.movedim(m + dim, 0).contiguous(), None, None,
                ctx.groups[m]))
            g = g.movedim(0, m)
        return g.reshape(-1, *g.shape[len(sizes) + 1:]), None, None, None


def waited(t):
    """A collective's result as a plain tensor (its views would stay
    asynchronous wrappers, which a DTensor cannot hold with autograd)."""
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def shard_to_rows(x, dim: int, mesh_dims=None):
    """DTensor ``x`` sharded on its dim ``dim`` (``Shard(dim)``) on the
    mesh dims ``mesh_dims`` (default all that do) laid out by rows there
    instead (``Shard(0)``), by explicit all-to-alls (``_ShardToRows``):
    the embedding's width, the MoE's experts. DTensor's own
    ``redistribute`` would gather it whole on a CPU mesh, and its plan
    across several mesh dims is its own. Where the rows do not divide,
    or a mesh dim after the first of them also splits the rows, ``x``
    itself."""
    mesh = x.device_mesh
    dims = [i for i, p in enumerate(x.placements) if p == Shard(dim)
            and (mesh_dims is None or i in mesh_dims)]
    sizes = tuple(mesh.size(i) for i in dims)
    if not dims or x.shape[0] % math.prod(sizes) or any(
            p == Shard(0) for p in x.placements[dims[0]:]):
        return x
    want = tuple(Shard(0) if i in dims else p
                 for i, p in enumerate(x.placements))
    groups = tuple((mesh, i) for i in dims)
    return summed_map(lambda t: _ShardToRows.apply(t, dim, groups, sizes),
                      out_placements=list(want),
                      in_placements=(list(x.placements),))(x)


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


def summed_map(fn, out_placements, in_placements, out_shapes=None):
    """``fn`` run rank by rank on the local tensors of DTensor inputs laid
    out as ``in_placements``, its outputs DTensors laid out as
    ``out_placements`` (``local_map``'s contract), whose backward adds
    the ranks' gradients of a replicated input: an input replicated on a
    mesh dim that splits an output (a weight beside batch-sharded rows,
    kv heads beside a rank's q heads) gets on each rank the gradient of
    that rank's share alone, which ``local_map`` would declare the
    replicated whole; it is declared a partial sum there instead, so
    DTensor adds the shares. ``out_shapes``: the outputs' global shapes,
    for outputs sharded unevenly (by default every shard is taken for as
    large as this rank's); such an output is made contiguous."""
    outs = (out_placements if isinstance(out_placements, tuple)
            else (out_placements,))
    split = {d for pl in outs for d, p in enumerate(pl)
             if isinstance(p, Shard)}

    def call(*args):
        summed = []
        for a, pl in zip(args, in_placements):
            if isinstance(a, DTensor) and a.requires_grad:
                dims = tuple(d for d in sorted(split) if pl[d] == Replicate()
                             and a.device_mesh.size(d) > 1)
                if dims:
                    a = _PartialGrad.apply(a, dims)
            summed.append(a)
        mesh = next(a.device_mesh for a in summed if isinstance(a, DTensor))
        out = fn(*(waited(a.to_local()) if isinstance(a, DTensor) else a
                   for a in summed))
        made = tuple(
            DTensor.from_local(t, mesh, pl, run_check=False)
            if shape is None else DTensor.from_local(
                t.contiguous(), mesh, pl, run_check=False,
                shape=torch.Size(shape), stride=_contiguous(shape))
            for t, pl, shape in zip(out if isinstance(out, tuple) else (out,),
                                    outs, out_shapes or (None,) * len(outs)))
        return made if isinstance(out_placements, tuple) else made[0]

    return call


def _contiguous(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    strides, n = [], 1
    for size in reversed(shape):
        strides.append(n)
        n *= size
    return tuple(reversed(strides))


def current_layout() -> str:
    return _current()[1]


def reinstall():
    """A context manager that installs the (mesh, layout) installed now,
    to enter later: a rematerialised layer recomputes inside the
    backward, which on the card runs on autograd's device thread, where
    this thread's state is not installed."""
    return _installed(*_current())


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


def tp_dim(mesh):
    """The mesh dim the installed layout's "tp" names, where it has more
    than one rank; else None."""
    installed, layout = _current()
    if installed is None:
        return None
    tp = _resolve(mesh.mesh_dim_names, layout, "tp")
    if tp is None or mesh.size(mesh.mesh_dim_names.index(tp)) == 1:
        return None
    return mesh.mesh_dim_names.index(tp)


def uneven_heads(x, n: int) -> bool:
    """Whether ``n`` heads of DTensor ``x`` go on the tensor-parallel axis
    unevenly: the installed layout has one, of a size that does not
    divide ``n``."""
    if not isinstance(x, DTensor):
        return False
    i = tp_dim(x.device_mesh)
    return i is not None and n % x.device_mesh.size(i) != 0


def _head_weight(w, shape: tuple, dim: int):
    """Weight ``w`` gathered whole, viewed as ``shape`` and sharded on the
    tensor-parallel mesh dim by its dim ``dim`` (whole heads, unevenly)."""
    mesh = w.device_mesh
    i = tp_dim(mesh)
    wp = tuple(Shard(dim) if j == i else Replicate()
               for j in range(mesh.ndim))
    whole = w.redistribute(mesh, (Replicate(),) * mesh.ndim)
    return whole.view(*shape).redistribute(mesh, wp), wp


def project_heads(x, w, n: int, d: int, uneven: bool = False):
    """``x @ w`` viewed as (..., n, d) heads, x (..., D), w (D, n·d). For
    DTensors pinned ("dp", None, "tp", None): the heads on the
    tensor-parallel axis where its size divides ``n`` (``split_last``),
    else held whole, or with ``uneven`` sharded there by whole heads,
    unevenly: ``torch.chunk``'s rule, ceil(n / ranks) heads a rank and
    none on the ranks past the last head, as GSPMD pads them (12 heads
    on 16 ranks: one a rank, four ranks idle). Then each rank projects
    its own heads (``summed_map``: x's gradient is the sum of the ranks'
    heads', w's of the ranks' rows)."""
    if not isinstance(x, DTensor):
        y = x @ w
        return y.reshape(*y.shape[:-1], n, d)
    if not (uneven and uneven_heads(x, n)):
        return annotate(split_last(x @ gathered(w, x), n, d), "dp", None,
                        "tp", None)
    mesh = x.device_mesh
    i = tp_dim(mesh)
    wh, wp = _head_weight(w, (w.shape[0], n, d), 1)
    xp = tuple(Replicate() if j == i else p
               for j, p in enumerate(x.placements))
    out = tuple(Shard(x.ndim - 1) if j == i else p for j, p in enumerate(xp))

    def local(xl, wl):
        y = xl @ wl.reshape(wl.shape[0], -1)
        return y.reshape(*y.shape[:-1], wl.shape[1], d)

    return summed_map(local, out_placements=list(out),
                      in_placements=(list(xp), list(wp)),
                      out_shapes=((*x.shape[:-1], n, d),))(
        x.redistribute(mesh, xp), wh)


def project_from_heads(o, w):
    """``o`` (..., n, d) merged to (..., n·d) and multiplied by w (n·d,
    D). Heads a tensor-parallel axis does not divide, as
    ``project_heads`` lays them out: each rank contracts its heads with
    their rows of w, and the products are a partial sum on that axis,
    added where they are next used, as XLA splits a row-parallel
    product; otherwise the merge of whole-head shards (``merge_last``)
    and the product with w gathered as it is used."""
    if not isinstance(o, DTensor):
        return o.reshape(*o.shape[:-2], -1) @ w
    n, d = o.shape[-2:]
    if not uneven_heads(o, n):
        o = merge_last(o)
        return o @ gathered(w, o)
    mesh = o.device_mesh
    i = tp_dim(mesh)
    wh, wp = _head_weight(w, (n, d, w.shape[1]), 0)
    op = tuple(Shard(o.ndim - 2) if j == i else p
               for j, p in enumerate(o.placements))
    out = tuple(Partial() if j == i else p for j, p in enumerate(op))

    def local(ol, wl):
        return ol.reshape(*ol.shape[:-2], -1) @ wl.reshape(-1, wl.shape[-1])

    return summed_map(local, out_placements=list(out),
                      in_placements=(list(op), list(wp)),
                      out_shapes=((*o.shape[:-2], w.shape[1]),))(
        o.redistribute(mesh, op), wh)


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

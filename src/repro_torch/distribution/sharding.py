"""Sharding rules: FSDP ("data", + "pod" when present) × TP ("model").

Port of ``src/repro/distribution/sharding.py``. The rules are the
reference's, divisibility fallbacks and all: a dim is sharded on its
candidate axis only when the axis size divides it, otherwise the next
candidate (or replication) is used.

Scheme (params):
  column-parallel (wq/wk/wv/wi/wg/in_proj):  (fsdp, tp)
  row-parallel    (wo/out_proj):             (tp, fsdp)
  embed (V, D): (tp, fsdp)   unembed (D, V): (fsdp, tp)
  MoE (E, D, F): experts on tp when E % tp == 0 (qwen3: 128/16), else the
  expert-FFN dim on tp (grok: 8 experts, F=32768/16) with D on fsdp.

Batch: leading batch dim on (pod, data). Decode caches: batch on dp when it
divides, else the *sequence* dim on dp (context parallelism — the long_500k
path); KV heads on tp with head-dim fallback (GQA with 1–4 KV heads).

What changed, in two steps:

  * The rules compute a spec, one entry a tensor dim (None, an axis name
    or a tuple of axis names, the reference's ``PartitionSpec`` entries),
    from the mesh's axis names and sizes alone (``Axes``; a
    ``DeviceMesh`` is read through ``axes_of``), as the reference's rules
    do from an ``AbstractMesh``. ``*_specs`` return them.
  * ``placements(mesh, spec)`` turns a spec into DTensor placements: a
    ``Shard(d)`` on every mesh dim that names tensor dim ``d``, in the
    mesh's order (("pod", "data") on dim 0 is ``Shard(0)`` on both), else
    ``Replicate()``. ``*_shardings`` return them.

Parameters are keyed by the port's names (``Model.named_parameters()``).
The reference stacks each layer kind's weights along leading axes and
never shards those; the port keeps one tensor a layer, so the rule runs on
the reference leaf's path (``weights._stacked``) with the tensor's own
shape, which is the stacked leaf's trailing dims. Caches keep the
reference's stacked layout and its paths.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
from torch import nn
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                     distribute_tensor)


@dataclasses.dataclass(frozen=True)
class Axes:
    """A mesh's axis names and sizes, in the mesh's order."""
    names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.names, self.sizes))

    @property
    def axis_names(self) -> tuple:
        return self.names


def axes_of(mesh) -> Axes:
    """``Axes`` of a ``DeviceMesh`` (or an ``Axes``, returned as is)."""
    if isinstance(mesh, Axes):
        return mesh
    return Axes(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = axes_of(mesh).shape
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def mesh_axes(mesh, layout: str = "2d") -> tuple:
    """Returns (dp_axes, tp_axis). layout="dp" folds the model axis into
    the batch axis (pure data parallelism of activations)."""
    names = axes_of(mesh).names
    if layout == "dp":
        return tuple(a for a in names
                     if a in ("pod", "data", "model")), "model"
    dp = tuple(a for a in names if a in ("pod", "data"))
    return dp, "model"


def _pick(mesh, dim: int, candidates) -> object:
    """First candidate axis (or axis tuple) that divides ``dim``; else None."""
    for cand in candidates:
        if cand is None:
            return None
        if dim % _axis_size(mesh, cand) == 0:
            return cand
    return None


def spec_for_param(mesh, path: str, shape: tuple) -> tuple:
    """The reference's ``_spec_for_param``: ``path`` is the reference's
    leaf path ("layers/moe/wi")."""
    dp, tp = mesh_axes(mesh)
    ndim = len(shape)
    leaf = path.split("/")[-1]
    in_moe = "/moe/" in path or path.endswith("moe")

    def lead(n_rule: int):
        return [None] * (ndim - n_rule)

    if ndim == 0 or leaf in ("scale", "conv_b", "A_log", "dt_bias", "D",
                             "gate_norm", "step"):
        return ()
    if leaf == "embed":
        return (_pick(mesh, shape[0], [tp]), _pick(mesh, shape[1], [dp]))
    if leaf == "unembed":
        return (_pick(mesh, shape[0], [dp]), _pick(mesh, shape[1], [tp]))
    if in_moe and leaf in ("wi", "wg", "wo") and ndim >= 3:
        e, d1, d2 = shape[-3:]
        if e % _axis_size(mesh, tp) == 0:
            spec = [tp, _pick(mesh, d1, [dp]), None]
        elif leaf == "wo":   # (E, F, D): F row-parallel
            spec = [None, _pick(mesh, d1, [tp]), _pick(mesh, d2, [dp])]
        else:                # (E, D, F): F column-parallel
            spec = [None, _pick(mesh, d1, [dp]), _pick(mesh, d2, [tp])]
        return (*lead(3), *spec)
    if leaf in ("wq", "wk", "wv", "wi", "wg", "in_proj") and ndim >= 2:
        d_in, d_out = shape[-2:]
        return (*lead(2), _pick(mesh, d_in, [dp]), _pick(mesh, d_out, [tp]))
    if leaf in ("wo", "out_proj") and ndim >= 2:
        d_in, d_out = shape[-2:]
        return (*lead(2), _pick(mesh, d_in, [tp]), _pick(mesh, d_out, [dp]))
    if leaf == "router" and ndim >= 2:
        return (*lead(2), _pick(mesh, shape[-2], [dp]), None)
    if leaf == "conv_w" and ndim >= 2:
        return (*lead(2), None, _pick(mesh, shape[-1], [tp]))
    # default: replicate (small/unknown leaves)
    return (None,) * ndim


def placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec``: ``Shard(d)`` on each mesh dim that
    tensor dim ``d`` names, ``Replicate()`` on the others."""
    out = []
    for name in axes_of(mesh).names:
        dims = [d for d, entry in enumerate(spec)
                if entry == name or (isinstance(entry, tuple)
                                     and name in entry)]
        if len(dims) > 1:
            raise ValueError(f"mesh axis {name!r} shards dims {dims} of "
                             f"one spec {spec}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def reference_path(name: str) -> str:
    """The reference's leaf path of a port parameter name
    ("layers.3.moe.wi" -> "layers/moe/wi")."""
    from ..models.weights import _stacked
    return _stacked(name)[0].replace(".", "/")


def _named(params) -> dict:
    """name -> shape of a ``Model`` or of a mapping of tensors."""
    items = (params.named_parameters() if hasattr(params, "named_parameters")
             else params.items())
    return {k: tuple(v.shape) for k, v in items}


def param_specs(mesh, params) -> dict:
    """Spec of every parameter of ``params`` (a ``Model``, or tensors keyed
    by parameter name), by name."""
    return {k: spec_for_param(mesh, reference_path(k), s)
            for k, s in _named(params).items()}


def param_shardings(mesh, params) -> dict:
    """Placements of every parameter, by name."""
    return {k: placements(mesh, s)
            for k, s in param_specs(mesh, params).items()}


def opt_state_specs(mesh, opt_state: Mapping) -> dict:
    """mu/nu mirror the param layout; step is replicated."""
    return {"mu": param_specs(mesh, opt_state["mu"]),
            "nu": param_specs(mesh, opt_state["nu"]), "step": ()}


def opt_state_shardings(mesh, opt_state: Mapping) -> dict:
    return _tree_map(lambda s: placements(mesh, s),
                     opt_state_specs(mesh, opt_state))


def _tree_map(fn, tree: Mapping):
    return {k: _tree_map(fn, v) if isinstance(v, Mapping) else fn(v)
            for k, v in tree.items()}


def _map_paths(fn, tree: Mapping, prefix: str = ""):
    return {k: (_map_paths(fn, v, f"{prefix}{k}/") if isinstance(v, Mapping)
                else fn(prefix + k, tuple(v.shape)))
            for k, v in tree.items()}


def batch_specs(mesh, batch: Mapping, layout: str = "2d") -> dict:
    """Leading batch dim on dp (or dp without its first axis, else
    replicated); scalars replicated. ``batch``: tensors (or anything with
    a ``shape``) by name."""
    dp, tp = mesh_axes(mesh, layout)

    def one(path, shape):
        if not shape:
            return ()
        spec = [None] * len(shape)
        spec[0] = _pick(mesh, shape[0], [dp, tuple(dp[1:]) or None])
        return tuple(spec)

    return _map_paths(one, batch)


def batch_shardings(mesh, batch: Mapping, layout: str = "2d") -> dict:
    return _tree_map(lambda s: placements(mesh, s),
                     batch_specs(mesh, batch, layout))


def cache_specs(mesh, cache: Mapping, batch_size: int,
                layout: str = "2d") -> dict:
    """Decode-cache layout. KV caches (L, B, S, Hkv, Dh): B on dp when it
    divides; otherwise S on dp (context parallelism, the batch=1 long-context
    case). Hkv on tp with Dh fallback. SSM states (L, B, H, N, P): heads on
    tp with state/head-dim fallbacks."""
    dp, tp = mesh_axes(mesh, layout)
    batch_on_dp = batch_size % _axis_size(mesh, dp) == 0

    def one(path, shape):
        leafname = path.split("/")[-1]
        spec = [None] * len(shape)
        if leafname in ("k", "v", "xk", "xv") and len(shape) == 5:
            if batch_on_dp:
                spec[1] = dp
            else:
                spec[2] = _pick(mesh, shape[2], [dp])
            spec[3] = _pick(mesh, shape[3], [tp])
            if spec[3] is None:
                spec[4] = _pick(mesh, shape[4], [tp])
        elif leafname == "ssm":
            b_ax = len(shape) - 4
            if batch_on_dp:
                spec[b_ax] = dp
            spec[b_ax + 1] = _pick(mesh, shape[b_ax + 1], [tp])
            if spec[b_ax + 1] is None:
                spec[b_ax + 2] = _pick(mesh, shape[b_ax + 2], [tp])
        elif leafname == "conv":
            b_ax = len(shape) - 3
            if batch_on_dp:
                spec[b_ax] = dp
            spec[-1] = _pick(mesh, shape[-1], [tp])
        return tuple(spec)

    return _map_paths(one, cache)


def cache_shardings(mesh, cache: Mapping, batch_size: int,
                    layout: str = "2d") -> dict:
    return _tree_map(lambda s: placements(mesh, s),
                     cache_specs(mesh, cache, batch_size, layout))


def replicated(mesh, tree: Mapping) -> dict:
    """``Replicate()`` on every mesh dim, for every leaf of ``tree``."""
    rep = tuple(Replicate() for _ in axes_of(mesh).names)
    return _tree_map(lambda _: rep, tree)


# ------------------------------------------------------------- distribute
def shard(t, mesh, placement) -> DTensor:
    """DTensor of the global tensor ``t`` (the same on every rank): each
    rank keeps its own slice (``src_data_rank=None``: no collective), in a
    storage of its own, not a view of ``t``."""
    d = distribute_tensor(t.detach(), mesh, placement, src_data_rank=None)
    local = d.to_local()
    if local.untyped_storage().nbytes() > local.numel() * local.element_size():
        d = DTensor.from_local(local.clone(), mesh, placement, run_check=False,
                               shape=d.shape, stride=d.stride())
    return d


def distribute_model(model, mesh, shardings: Mapping | None = None):
    """Replace every parameter of ``model`` by its DTensor, placed by
    ``shardings`` (default ``param_shardings(mesh, model)``), in place;
    returns ``model``."""
    shardings = param_shardings(mesh, model) if shardings is None \
        else shardings
    for name, p in list(model.named_parameters()):
        *path, leaf = name.split(".")
        mod = model.get_submodule(".".join(path))
        mod._parameters[leaf] = nn.Parameter(
            shard(p, mesh, shardings[name]), requires_grad=p.requires_grad)
    return model


def distribute_tree(tree: Mapping, mesh, shardings: Mapping) -> dict:
    """A nested dict of tensors as DTensors placed by ``shardings`` (the
    same nesting)."""
    return {k: (distribute_tree(v, mesh, shardings[k])
                if isinstance(v, Mapping) else shard(v, mesh, shardings[k]))
            for k, v in tree.items()}


def sharded_zeros(tree: Mapping, mesh, shardings: Mapping,
                  device=None) -> dict:
    """Zeros DTensors shaped as ``tree``'s tensors (meta tensors do),
    placed by ``shardings``: each rank allocates only its shard."""
    def one(t, pl):
        shape = list(t.shape)
        for i, p in enumerate(pl):
            if isinstance(p, Shard):
                shape[p.dim] //= mesh.size(i)
        local = torch.zeros(shape, dtype=t.dtype, device=device)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return {k: (sharded_zeros(v, mesh, shardings[k], device)
                if isinstance(v, Mapping) else one(v, shardings[k]))
            for k, v in tree.items()}

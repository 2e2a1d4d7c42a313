"""Move parameters between the reference's tree and the port's ``Model``.

No module of ``repro`` answers to this one: the reference keeps its
parameters as one pytree with each layer kind's weights stacked along a
leading axis (``layers``: [L, ...], the MoE's experts [L, E, ...]; the
audio ``encoder``: [Le, ...]; the hybrid's ``mamba_groups``: [n_groups,
every, ...] and ``mamba_tail``: [tail, ...]), where the port keeps one
``nn.Module`` a layer. ``from_reference`` unstacks the tree (taken as
numpy arrays, so that nothing here imports JAX) into a ``Model`` whose
parameter names are the tree's paths: parameter
``mamba_groups.2.4.mamba.in_proj`` is
``tree["mamba_groups"]["mamba"]["in_proj"][2, 4]`` and
``encoder.3.attn.wq`` is ``tree["encoder"]["attn"]["wq"][3]``. The tests
hold the port against the reference on weights shared this way.
``to_reference`` goes the other way, for any tensors keyed by parameter
name (gradients, optimizer moments too): the tests compare gradients
leaf by leaf with it, and checkpoints keep the reference's on-disk
layout through it.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .. import cuda
from ..configs.base import ArchConfig
from .transformer import Model

STACKED = ("layers", "mamba_groups", "mamba_tail", "encoder")


def _leaves(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(_leaves(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out


def from_reference(cfg: ArchConfig, tree: Mapping, *,
                   device=None) -> Model:
    """The port's ``Model`` of ``cfg`` holding the reference's parameter
    pytree ``tree`` (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, repro.models.transformer.init_params(cfg,
    key))``), on ``device`` (the card unless ``"cpu"`` is asked for).
    Raises ``ValueError`` unless every leaf of the tree fills exactly one
    parameter of the same shape."""
    dev = cuda.resolve_device(device)
    model = Model(cfg, None, "meta").to_empty(device=dev)
    leaves = _leaves(tree)
    used = set()
    for name, p in model.named_parameters():
        key, index = _stacked(name)
        if key not in leaves:
            raise ValueError(f"{cfg.name}: no reference leaf {key!r} for "
                             f"parameter {name!r}")
        value = np.asarray(leaves[key])[index]
        if value.shape != tuple(p.shape):
            raise ValueError(f"{cfg.name}: {name} is {tuple(p.shape)}, the "
                             f"reference's {key}{list(index)} "
                             f"{value.shape}")
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.array(value, np.float32)))
        used.add(key)
    if used != set(leaves):
        raise ValueError(f"{cfg.name}: reference leaves with no parameter: "
                         f"{sorted(set(leaves) - used)}")
    return model


def _stacked(name: str) -> tuple:
    """(reference key, index) of a port parameter name: parameter
    ``mamba_groups.2.4.mamba.in_proj`` is ``mamba_groups.mamba.in_proj``
    at [2, 4]."""
    top, *rest = name.split(".")
    index = ()
    if top in STACKED:
        depth = 2 if top == "mamba_groups" else 1
        index, rest = tuple(int(i) for i in rest[:depth]), rest[depth:]
    return ".".join([top, *rest]), index


def to_reference(cfg: ArchConfig, named: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of ``from_reference``: tensors keyed by the port's
    parameter names (parameters, their gradients or an optimizer's
    moments) restacked into the reference's nested tree of numpy arrays,
    each layer kind's tensors along a leading axis ([L, ...]; the
    hybrid's ``mamba_groups`` [n_groups, every, ...]). bf16 tensors come
    out as float32 (exact; numpy has no bf16). The arrays are copies.
    Raises ``ValueError`` unless the names are exactly ``cfg``'s
    parameters."""
    want = {n for n, _ in Model(cfg, None, "meta").named_parameters()}
    if set(named) != want:
        raise ValueError(f"{cfg.name}: names differ from the model's "
                         f"parameters: {sorted(set(named) ^ want)[:6]}")
    parts: dict = {}
    for name, t in named.items():
        key, index = _stacked(name)
        t = t.detach()
        # a copy, never a view of a CPU tensor that training overwrites
        parts.setdefault(key, {})[index] = (
            t.float() if t.dtype == torch.bfloat16 else t).to(
                "cpu", copy=True).numpy()
    tree: dict = {}
    for key, pieces in parts.items():
        if () in pieces:
            value = pieces[()]
        else:
            shape = tuple(max(i[d] for i in pieces) + 1
                          for d in range(len(next(iter(pieces)))))
            first = next(iter(pieces.values()))
            value = np.empty(shape + first.shape, first.dtype)
            for index, piece in pieces.items():
                value[index] = piece
        node = tree
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree

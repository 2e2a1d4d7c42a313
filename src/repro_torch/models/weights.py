"""Load the reference's parameters into the port's ``Model``.

No module of ``repro`` answers to this one: the reference keeps its
parameters as one pytree with each layer kind's weights stacked along a
leading axis (``layers``: [L, ...]; the hybrid's ``mamba_groups``:
[n_groups, every, ...] and ``mamba_tail``: [tail, ...]), where the port
keeps one ``nn.Module`` a layer. ``from_reference`` unstacks the tree
(taken as numpy arrays, so that nothing here imports JAX) into a
``Model`` whose parameter names are the tree's paths: parameter
``mamba_groups.2.4.mamba.in_proj`` is
``tree["mamba_groups"]["mamba"]["in_proj"][2, 4]``. The tests hold the
port against the reference on weights shared this way.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .. import cuda
from ..configs.base import ArchConfig
from .transformer import Model

STACKED = ("layers", "mamba_groups", "mamba_tail")


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
        top, *rest = name.split(".")
        index = ()
        if top in STACKED:
            depth = 2 if top == "mamba_groups" else 1
            index, rest = tuple(int(i) for i in rest[:depth]), rest[depth:]
        key = ".".join([top, *rest])
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

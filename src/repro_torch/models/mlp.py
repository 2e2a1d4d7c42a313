"""Dense MLP layer.

Port of ``src/repro/models/mlp.py``: ``make_mlp`` / ``apply_mlp`` become
the ``MLP`` module, with the reference's parameter names (``wi``, ``wg``,
``wo``), shapes (d_in, d_out) and arithmetic: products in the compute
dtype, left to ``torch.matmul`` as the reference leaves them to XLA. Its
``annotate`` sharding hints are no-ops without a mesh and are left out.
``make_moe`` / ``apply_moe`` wait for the ``moe`` family (ROADMAP Queue
1).
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ArchConfig
from .layers import activation, dense_init, param


class MLP(nn.Module):
    def __init__(self, cfg: ArchConfig, d: int, ff: int, gen=None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.wi = param(dense_init(gen, d, ff, device=device))
        self.wo = param(dense_init(gen, ff, d, device=device))
        self.wg = (param(dense_init(gen, d, ff, device=device))
                   if cfg.act in ("swiglu", "geglu") else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        up = x @ self.wi.to(dt)
        gate = x @ self.wg.to(dt) if self.wg is not None else None
        return activation(self.cfg, gate, up) @ self.wo.to(dt)

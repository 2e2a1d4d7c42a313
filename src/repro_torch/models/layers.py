"""Shared model layers: norms, RoPE (incl. M-RoPE), initializers.

Port of ``src/repro/models/layers.py``. Parameters are ``nn.Parameter``s
of the port's ``nn.Module`` blocks instead of a nested dict; the
functions on tensors keep the reference's names and arithmetic. Compute
dtype is bf16 (``COMPUTE_DTYPE``): weights stay float32, as
``dense_init`` makes them, and are cast where they are used; norms and
softmax accumulate in float32. What changed:

  * ``dense_init`` / ``embed_init`` draw from a ``torch.Generator`` (the
    reference's ``jax.random`` keys give other numbers from the same
    seed; the tests share weights through ``weights.from_reference``);
  * ``make_norm`` / ``apply_norm`` become the ``Norm`` module.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ArchConfig

EPS = 1e-6
COMPUTE_DTYPE = torch.bfloat16


def param(t: torch.Tensor) -> nn.Parameter:
    """A trainable float32 weight. Code that only evaluates runs under
    ``torch.no_grad()`` or ``torch.inference_mode()`` (the serving engine
    does), so that it builds no autograd graph."""
    return nn.Parameter(t)


# ------------------------------------------------------------------- norms
def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = EPS) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def layernorm_np(x: torch.Tensor) -> torch.Tensor:
    """Non-parametric LayerNorm (OLMo): no scale, no bias."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + EPS)).to(x.dtype)


class Norm(nn.Module):
    """``make_norm`` + ``apply_norm``: rmsnorm with a zero-initialised
    scale, or the parameter-free ``layernorm_np``. The rmsnorm's epsilon
    is ``EPS``, or the config's ``norm_eps`` where it has one (the port's
    own ``hybrid_moe`` family)."""

    def __init__(self, cfg: ArchConfig, d: int, device=None):
        super().__init__()
        self.kind = cfg.norm
        self.eps = getattr(cfg, "norm_eps", EPS)
        if cfg.norm == "rmsnorm":
            self.scale = param(torch.zeros((d,), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "rmsnorm":
            return rmsnorm(x, self.scale, self.eps)
        return layernorm_np(x)


# -------------------------------------------------------------------- rope
def rope_angles(cfg: ArchConfig, positions: torch.Tensor) -> torch.Tensor:
    """positions: (..., ) integer -> angles (..., d_head//2) fp32.

    M-RoPE (qwen2-vl): positions (..., 3) with (t, h, w) components; the
    half-dim frequency slots are split into three sections.
    """
    half = cfg.d_head // 2
    inv_freq = cfg.rope_theta ** (
        -torch.arange(0, half, dtype=torch.float32,
                      device=positions.device) / half)
    if cfg.m_rope:
        # section split (t, h, w) ≈ (¼, ⅜, ⅜) of the half-dims
        s1 = half // 4
        s2 = s1 + (half - s1) // 2
        sec = torch.tensor([0] * s1 + [1] * (s2 - s1) + [2] * (half - s2),
                           device=positions.device)
        return positions.float()[..., sec] * inv_freq  # (..., half)
    return positions[..., None].float() * inv_freq


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); angles: (B, S, D//2). Rotate-half convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# -------------------------------------------------------------------- init
def dense_init(gen: torch.Generator | None, d_in: int, d_out: int,
               scale: float | None = None, device=None) -> torch.Tensor:
    s = scale if scale is not None else d_in ** -0.5
    return torch.randn((d_in, d_out), generator=gen, device=device) * s


def embed_init(gen: torch.Generator | None, vocab: int, d: int,
               device=None, std: float = 0.02) -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen, device=device) * std


def activation(cfg: ArchConfig, gate: torch.Tensor | None,
               up: torch.Tensor) -> torch.Tensor:
    gelu = torch.nn.functional.gelu
    if cfg.act == "swiglu":
        return torch.nn.functional.silu(gate) * up
    if cfg.act == "geglu":
        return gelu(gate, approximate="tanh") * up
    return gelu(up, approximate="tanh")  # plain gelu MLP


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return cap * torch.tanh(x / cap)
    return x

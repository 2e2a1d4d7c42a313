"""Mamba2 (SSD) block: chunked prefill through the SSD kernel, O(1) decode.

Port of ``src/repro/models/mamba2.py``. ``make_mamba`` / ``apply_mamba`` /
``decode_mamba`` become the ``Mamba`` module (the reference's parameter
names and shapes; ``forward`` is ``apply_mamba``, ``decode`` is
``decode_mamba``). The reference's ``_ssd_chunked`` is a ``lax.scan``
over chunks (``:113``); here it is the call site of the port's
hand-written SSD kernels, ``kernels.ssd.ssd_scan``: x (B, S, H, P) goes to
(B·H, S, P), dt (B, S, H) to (B·H, S), ``a`` repeats for each batch row,
B and C (B, S, N) expand to (B·H, S, N), all float32 as the reference
upcasts (``:84-103``), and the kernel also returns the state after the
last step, the decode cache. The sequence is padded to the chunk as the
reference pads it (zero dt: a pad step neither decays nor feeds the
state). Nothing falls back: on the card every call launches the kernels,
on the CPU the wrapper runs its plain version. ``_causal_conv`` and the
decode step are plain PyTorch, as the reference computes them outside
any kernel. The reference's ``h0`` (never passed by the model) is left
out: the kernels start from a zero state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..kernels import ssd as ssd_kernel
from .layers import dense_init, param, rmsnorm

CONV_DTYPE = torch.bfloat16  # the decode cache's raw conv inputs


def dims(cfg: ArchConfig) -> tuple:
    d_in = cfg.ssm_expand * cfg.d_model
    nh = cfg.ssm_heads
    hd = d_in // nh
    n = cfg.ssm_state
    return d_in, nh, hd, n


def _split(cfg: ArchConfig, proj: torch.Tensor) -> tuple:
    d_in, nh, hd, n = dims(cfg)
    z = proj[..., :d_in]
    xbc = proj[..., d_in:2 * d_in + 2 * n]
    dt = proj[..., 2 * d_in + 2 * n:]
    return z, xbc, dt


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width K: x (B,S,C), w (K,C)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i].to(x.dtype)
              for i in range(k))
    return F.silu(out + b.to(x.dtype))


def _ssd_chunked(x, dt, a, bmat, cmat, chunk: int) -> tuple:
    """Chunked SSD scan, one ``ssd_scan`` call.

    x: (B, S, H, P); dt: (B, S, H); a: (H,) negative; b/c: (B, S, N).
    Returns (y, h_final) with y like x, h (B, H, N, P) fp32.
    """
    bsz, s, nh, p = x.shape
    n = bmat.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} must be chunk-padded (chunk {chunk})")

    def per_head(t: torch.Tensor) -> torch.Tensor:  # (B, S, N) -> (B·H, S, N)
        return t.float()[:, None].expand(bsz, nh, s, n).reshape(
            bsz * nh, s, n).contiguous()  # at B = 1 a reshape is a view

    y, h = ssd_kernel.ssd_scan(
        x.float().permute(0, 2, 1, 3).reshape(bsz * nh, s, p).contiguous(),
        dt.float().permute(0, 2, 1).reshape(bsz * nh, s).contiguous(),
        a.float().repeat(bsz), per_head(bmat), per_head(cmat), chunk=chunk,
        final_state=True)
    y = y.reshape(bsz, nh, s, p).permute(0, 2, 1, 3).to(x.dtype)
    return y, h.reshape(bsz, nh, n, p)


class Mamba(nn.Module):
    def __init__(self, cfg: ArchConfig, gen=None, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        d_in, nh, hd, n = dims(cfg)
        conv_ch = d_in + 2 * n
        # projects to [z (d_in), xBC (d_in + 2n), dt (nh)]
        self.in_proj = param(dense_init(gen, d, 2 * d_in + 2 * n + nh,
                                        device=device))
        self.conv_w = param(torch.randn((cfg.conv_width, conv_ch),
                                        generator=gen, device=device) * 0.2)
        self.conv_b = param(torch.zeros((conv_ch,), device=device))
        self.A_log = param(torch.log(torch.linspace(1.0, 16.0, nh,
                                                    device=device)))
        self.dt_bias = param(torch.zeros((nh,), device=device))
        self.D = param(torch.ones((nh,), device=device))
        self.gate_norm = param(torch.zeros((d_in,), device=device))
        self.out_proj = param(dense_init(gen, d_in, d, device=device))

    def forward(self, x: torch.Tensor, return_cache: bool = False):
        """Full-sequence (prefill) path, ``apply_mamba``. x: (B, S, D).

        Returns ``(out, None)``, or with ``return_cache`` ``(out,
        (conv_state, ssm_state))`` for decode continuation: the last
        (conv_width-1) raw xBC inputs and the final SSD state."""
        cfg = self.cfg
        d_in, nh, hd, n = dims(cfg)
        dt_ = x.dtype
        proj = x @ self.in_proj.to(dt_)
        z, xbc, dt_raw = _split(cfg, proj)
        xbc_raw = xbc
        xbc = _causal_conv(xbc, self.conv_w, self.conv_b)
        xs = xbc[..., :d_in]
        bmat = xbc[..., d_in:d_in + n]
        cmat = xbc[..., d_in + n:]
        dt = F.softplus(dt_raw.float() + self.dt_bias)
        a = -torch.exp(self.A_log)
        bsz, s, _ = x.shape
        # pad sequence to chunk multiple
        chunk = cfg.ssm_chunk
        pad = (-s) % chunk
        if pad:
            xs, dt, bmat, cmat = (F.pad(t, (0, 0, 0, pad))
                                  for t in (xs, dt, bmat, cmat))
        xh = xs.reshape(bsz, s + pad, nh, hd)
        y, h_final = _ssd_chunked(xh, dt, a, bmat, cmat, chunk)
        y = y + self.D.to(y.dtype)[None, None, :, None] * xh  # skip
        y = y.reshape(bsz, s + pad, d_in)[:, :s]
        y = rmsnorm(y * F.silu(z), self.gate_norm)            # gated norm
        out = y @ self.out_proj.to(dt_)
        if not return_cache:
            return out, None
        cw = cfg.conv_width
        # a copy: a view would keep the whole projection alive in the cache
        conv_state = xbc_raw[:, s - (cw - 1):s].to(CONV_DTYPE, copy=True)
        return out, (conv_state, h_final)

    def decode(self, conv: torch.Tensor, ssm: torch.Tensor,
               x: torch.Tensor) -> tuple:
        """Single-token step, ``decode_mamba``. x: (B, 1, D); conv (B,
        conv_width-1, C) bf16, ssm (B, H, N, P) fp32 -> (y, new_conv,
        new_ssm)."""
        cfg = self.cfg
        d_in, nh, hd, n = dims(cfg)
        dt_ = x.dtype
        proj = x[:, 0] @ self.in_proj.to(dt_)                   # (B, ...)
        z, xbc, dt_raw = _split(cfg, proj)
        # conv update: window = [cache, current]
        win = torch.cat([conv, xbc[:, None, :].to(CONV_DTYPE)], dim=1)
        w = self.conv_w.to(dt_)
        conv_out = F.silu((win.to(dt_) * w[None]).sum(dim=1)
                          + self.conv_b.to(dt_))
        xs = conv_out[..., :d_in]
        bvec = conv_out[..., d_in:d_in + n].float()
        cvec = conv_out[..., d_in + n:].float()
        dt = F.softplus(dt_raw.float() + self.dt_bias)         # (B,H)
        a = -torch.exp(self.A_log)
        xh = xs.reshape(-1, nh, hd).float()
        decay = torch.exp(dt * a)                               # (B,H)
        h = (decay[:, :, None, None] * ssm
             + dt[:, :, None, None] * bvec[:, None, :, None]
             * xh[:, :, None, :])
        y = torch.einsum("bhnp,bn->bhp", h, cvec) + self.D[None, :, None] * xh
        y = y.reshape(-1, d_in).to(dt_)
        y = rmsnorm(y * F.silu(z), self.gate_norm)
        out = (y @ self.out_proj.to(dt_))[:, None, :]
        return out, win[:, 1:], h


def init_mamba_cache(cfg: ArchConfig, batch: int, device=None) -> dict:
    d_in, nh, hd, n = dims(cfg)
    conv_ch = d_in + 2 * n
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_ch),
                            dtype=CONV_DTYPE, device=device),
        "ssm": torch.zeros((batch, nh, n, hd), dtype=torch.float32,
                           device=device),
    }

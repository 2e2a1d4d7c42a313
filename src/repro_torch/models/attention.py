"""GQA attention: prefill through the flash-attention kernel, plain decode.

Port of ``src/repro/models/attention.py``. The reference's
``blockwise_attention`` is FlashAttention in plain JAX (a ``lax.scan``
over kv blocks, ``:87``, under a custom VJP); here it is the call site
of the port's hand-written kernel, ``kernels.flash_attention``: the
reference layout (B, S, H, D) goes to the kernel's (B·H, S, D), and k/v
to (B·Hkv, S, D), so query row ``b·H + h`` reads kv row ``(b·H + h) //
group = b·Hkv + h // group``, the kernel's GQA rule. The sequence is
padded up to a multiple of the tile and the result sliced back: under
the causal mask a padded key lies after every real query, so it is never
read. Tiling: ``TILE`` x ``TILE``, or ``SHORT_TILE`` when S is shorter
(a fixed default; serving a tuned tiling from a recording is later
work). A tiling the kernel refuses raises ``ConfigRejected``; nothing
falls back to the plain version, which runs only for tensors on the CPU
(the wrapper's own dispatch).

What changed: the reference's per-layer ``is_global`` flag becomes the
caller's choice of ``window`` (None on a global layer, the config's
window on a local one), the mask ``_mask_for`` builds; ``q_offset`` (0
on every prefill) and the custom VJP (training, the next slice) are left
out. The kernel keeps the probabilities in float32 for the PV product
where the reference casts them to bf16 first (``:79``), so the two
differ at bf16 level. ``attention_reference`` and ``decode_attention``
are plain PyTorch, as the reference computes them outside any kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import flash_attention as fa

NEG_INF = -1e30
TILE = 128         # block_q = block_kv of a prefill
SHORT_TILE = 64    # for a sequence shorter than TILE


def _mask_for(q_pos, kv_pos, *, causal: bool, window):
    """(Sq, Skv) boolean mask from absolute positions."""
    m = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= kv_pos[None, :]
    if window is not None:
        m &= (q_pos[:, None] - kv_pos[None, :]) < window
    return m


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int | None = None) -> torch.Tensor:
    """q: (B, S, H, D); k/v: (B, S, Hkv, D). Returns (B, S, H, D), one
    ``flash_attention`` call."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    tile = TILE if s >= TILE else SHORT_TILE
    pad = (-s) % tile
    if pad and not causal:
        raise ValueError("padding the sequence of a non-causal attention "
                         "would let every query read the pad keys")

    def heads_first(t: torch.Tensor, n: int) -> torch.Tensor:
        t = t.permute(0, 2, 1, 3)
        if pad:
            t = F.pad(t, (0, 0, 0, pad))
        return t.reshape(b * n, s + pad, d).contiguous()

    out = fa.flash_attention(heads_first(q, h), heads_first(k, hkv),
                             heads_first(v, hkv), block_q=tile,
                             block_kv=tile, causal=causal, window=window)
    return out.reshape(b, h, s + pad, d)[:, :, :s].permute(0, 2, 1, 3)


def attention_reference(q, k, v, *, causal=True,
                        window=None) -> torch.Tensor:
    """Materialized-S² oracle (tests only; the reference's ``q_offset``,
    never set, is left out)."""
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    g = h // hkv
    kf = torch.repeat_interleave(k, g, dim=2)
    vf = torch.repeat_interleave(v, g, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          kf.float()) * d ** -0.5
    q_pos = torch.arange(sq, device=q.device)
    mask = _mask_for(q_pos, torch.arange(skv, device=q.device),
                     causal=causal, window=window)
    logits = torch.where(mask[None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf.float()).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     window: int | None = None) -> torch.Tensor:
    """Single-step attention against a cache.

    q: (B, 1, H, D); caches: (B, S_max, Hkv, D); cache_len: (B,) or scalar —
    number of valid cache entries *including* the current token. Products
    sum in float32 from the compute-dtype operands, as the reference's
    ``preferred_element_type=float32`` einsums do.
    """
    b, _, h, d = q.shape
    _, smax, hkv, _ = k_cache.shape
    g = h // hkv
    qg = q.reshape(b, hkv, g, d)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                     k_cache.float()) * (d ** -0.5)
    kv_pos = torch.arange(smax, device=q.device)
    cl = torch.as_tensor(cache_len, device=q.device).broadcast_to((b,))
    valid = kv_pos[None, :] < cl[:, None]                    # causal+len
    if window is not None:
        valid &= (cl[:, None] - 1 - kv_pos[None, :]) < window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)

"""GQA attention: flash-attention kernel forward with the reference's
backward, plain decode.

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

Training: the reference's custom VJP (``_flash`` / ``_flash_fwd`` /
``_flash_bwd``, ``:96-161``) is the ``torch.autograd.Function``
``_Flash``. Its forward is the kernel, asked also for each q row's
logsumexp, and saves (q, k, v, out, lse), linear in S; its backward is
``_flash_bwd``, the reference's algorithm in PyTorch (the reference has
no Pallas backward): delta = sum(dout * out), then for each block of
``BWD_BLOCK_KV`` keys the probabilities p = exp(s - lse) recomputed
under the same mask, dv, dp, ds = p (dp - delta) scale, dq and dk, in
float32, dk and dv summed over each GQA group. It visits only the q rows
that see some key of the block (from the block's first key on under the
causal mask, up to its last key plus the window under a window): the
rows it skips have p = 0 exactly. A call whose inputs need no gradient
(serving) goes straight to the kernel and asks for no lse.

What changed: the reference's per-layer ``is_global`` flag becomes the
caller's choice of ``window`` (None on a global layer, the config's
window on a local one), the mask ``_mask_for`` builds; ``q_offset`` (0
on every prefill and training step) is left out. The kernel keeps the
probabilities in float32 for the PV product where the reference casts
them to bf16 first (``:79``), so the two differ at bf16 level.
``attention_reference`` and ``decode_attention`` are plain PyTorch, as
the reference computes them outside any kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import flash_attention as fa

NEG_INF = -1e30
TILE = 128         # block_q = block_kv of a prefill
SHORT_TILE = 64    # for a sequence shorter than TILE
BWD_BLOCK_KV = 256  # keys a step of the backward's loop


def _mask_for(q_pos, kv_pos, *, causal: bool, window):
    """(Sq, Skv) boolean mask from absolute positions."""
    m = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= kv_pos[None, :]
    if window is not None:
        m &= (q_pos[:, None] - kv_pos[None, :]) < window
    return m


def _flash_bwd(q, k, v, out, lse, dout, *, causal: bool, window) -> tuple:
    """The reference's ``_flash_bwd`` on the kernel's layout: q, out, dout
    (BH, S, D), k/v (BH_kv, S, D), lse (BH, S) float32. Returns (dq, dk,
    dv) in the inputs' dtypes."""
    bh, s, d = q.shape
    bh_kv = k.shape[0]
    g = bh // bh_kv
    scale = d ** -0.5
    qg = q.float().reshape(bh_kv, g, s, d)
    dog = dout.float().reshape(bh_kv, g, s, d)
    # D_i = sum_d dout * out (the flash backward trick)
    delta = (dog * out.float().reshape(bh_kv, g, s, d)).sum(-1)
    lse = lse.reshape(bh_kv, g, s)
    pos = torch.arange(s, device=q.device)
    dq = torch.zeros_like(qg)
    dk = torch.zeros((bh_kv, s, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for k0 in range(0, s, BWD_BLOCK_KV):
        k1 = min(k0 + BWD_BLOCK_KV, s)
        q0 = k0 if causal else 0            # rows that see a key of the block
        q1 = s if window is None else min(s, k1 - 1 + window)
        if q0 >= q1:
            continue
        kb, vb = k[:, None, k0:k1].float(), v[:, None, k0:k1].float()
        qs, dos = qg[:, :, q0:q1], dog[:, :, q0:q1]
        sc = (qs @ kb.transpose(-1, -2)) * scale          # (BHkv, g, q, k)
        mask = _mask_for(pos[q0:q1], pos[k0:k1], causal=causal,
                         window=window)
        sc = torch.where(mask, sc, NEG_INF)
        p = torch.exp(sc - lse[:, :, q0:q1, None])
        dv[:, k0:k1] = torch.einsum("hgqk,hgqd->hkd", p, dos)
        dp = dos @ vb.transpose(-1, -2)
        ds = p * (dp - delta[:, :, q0:q1, None]) * scale
        dq[:, :, q0:q1] += ds @ kb
        dk[:, k0:k1] = torch.einsum("hgqk,hgqd->hkd", ds, qs)
    return (dq.reshape(bh, s, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: the kernel's forward (with
    its lse), ``_flash_bwd``'s backward."""

    @staticmethod
    def forward(ctx, q, k, v, tile: int, causal: bool, window):
        out, lse = fa.flash_attention(q, k, v, block_q=tile, block_kv=tile,
                                      causal=causal, window=window,
                                      return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_flash_bwd(q, k, v, out, lse, dout, causal=ctx.causal,
                            window=ctx.window), None, None, None)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int | None = None) -> torch.Tensor:
    """q: (B, S, H, D); k/v: (B, S, Hkv, D). Returns (B, S, H, D), one
    ``flash_attention`` call; through ``_Flash`` (differentiable) when an
    input needs a gradient."""
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

    args = (heads_first(q, h), heads_first(k, hkv), heads_first(v, hkv))
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        out = _Flash.apply(*args, tile, causal, window)
    else:
        out = fa.flash_attention(*args, block_q=tile, block_kv=tile,
                                 causal=causal, window=window)
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

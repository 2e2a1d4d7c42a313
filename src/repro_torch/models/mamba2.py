"""Mamba2 (SSD) block: chunked SSD kernel forward with the reference's
chunked backward, O(1) decode.

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

Training: the reference differentiates its ``lax.scan`` under
``jax.checkpoint`` (``:107-113``); it has no Pallas backward. Here the
scan is the ``torch.autograd.Function`` ``_SSDScan``: its forward is the
kernel call, which also hands back each chunk's incoming state h_c (the
state scratch, no launch more); its backward, ``_ssd_bwd``, is the
gradient of the same chunked algorithm in PyTorch, chunk-parallel given
the saved h_c, with one reverse pass over the chunks for the state's
gradient. The per-head expansion of B and C, ``a``'s repeat over the
batch and the padding stay outside, so autograd sums their gradients. A
call whose inputs need no gradient (serving) goes straight to the
kernel.

DTensors: the scan and the causal conv run rank by rank on each shard
(``summed_map``, a ``local_map`` that sums a replicated input's
gradient over the ranks), batch rows on the dp axes and heads on tp, so
the (B·H, S, ...) layout and the per-head copies of B and C hold the
local rows and heads only. ``_ssd_bwd`` is also the operator
``repro_torch::ssd_scan_bwd`` (shapes and a flop count for fake
tensors). ``in_proj``'s output carries the reference's ``annotate`` pin,
in decode too; its product splits its contraction over a model axis its
width does not divide (``matmul_tp``; mamba2-130m's 3,352 on 16 ranks),
and decode splits and merges heads only along whole-head shards.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.flop_counter import register_flop_formula

from ..configs.base import ArchConfig
from ..distribution.annotate import (annotate, gathered, matmul_tp,
                                     merge_last, site_placements,
                                     split_last, summed_map)
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
    """Depthwise causal conv, width K: x (B,S,C), w (K,C). DTensors: rank
    by rank on each shard (``local_map``), batch rows on dp and channels
    on tp, the sequence whole (DTensor's pad of a sharded tensor is not
    dependable across PyTorch versions)."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        xp = site_placements(x, "dp", None, "tp")
        wp = tuple(Shard(1) if p == Shard(2) else Replicate() for p in xp)
        bp = tuple(Shard(0) if p == Shard(2) else Replicate() for p in xp)
        return summed_map(_causal_conv, out_placements=list(xp),
                          in_placements=(list(xp), list(wp), list(bp)))(
            x.redistribute(mesh, xp), w.redistribute(mesh, wp),
            b.redistribute(mesh, bp))
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i].to(x.dtype)
              for i in range(k))
    return F.silu(out + b.to(x.dtype))


def _ssd_bwd(x, dt, a, b, c, h_in, dy, dh, chunk: int) -> tuple:
    """Gradient of the chunked scan on the kernels' layout: x (BH, L, P),
    dt (BH, L), a (BH,), b/c (BH, L, N), h_in (BH, L / chunk, N, P) the
    states entering each chunk, dy like x, dh the final state's gradient
    (or None). Per chunk, with cum the in-chunk prefix sum of dt a, total
    its last entry, L = exp(cum_i - cum_j)[j <= i], W = (C B^T) o L o dt_j:
    y = W X + exp(cum) C h_c and h_{c+1} = exp(total) h_c + S_c, S_c =
    sum_j exp(total - cum_j) dt_j B_j (x) X_j. The state's gradient G_c
    comes from one reverse pass, G_c = direct_c + exp(total_c) G_{c+1}
    with direct_c = C^T (exp(cum) o dY); the rest is chunk-parallel.
    Returns (dx, ddt, da, db, dc), float32."""
    bh, l, p = x.shape
    n = b.shape[-1]
    nc = l // chunk
    xc, dyc = x.reshape(bh, nc, chunk, p), dy.float().reshape(bh, nc, chunk, p)
    bc, cc = b.reshape(bh, nc, chunk, n), c.reshape(bh, nc, chunk, n)
    dtc = dt.reshape(bh, nc, chunk)
    cum = torch.cumsum(dtc * a[:, None, None], dim=2)          # (BH, C, Q)
    total = cum[..., -1]                                        # (BH, C)
    idx = torch.arange(chunk, device=x.device)
    mask = idx[:, None] >= idx[None, :]
    ldecay = torch.where(mask, torch.exp(torch.where(
        mask, cum[..., :, None] - cum[..., None, :], 0.0)), 0.0)
    cb = cc @ bc.transpose(-1, -2)                              # (BH,C,Q,Q)
    w = cb * ldecay * dtc[..., None, :]
    # intra-chunk term y = W X
    dw = dyc @ xc.transpose(-1, -2)
    dx = w.transpose(-1, -2) @ dyc
    dm = dw * ldecay * dtc[..., None, :]
    dc = dm @ bc
    db = dm.transpose(-1, -2) @ cc
    ddt = (dw * cb * ldecay).sum(-2)
    e = dw * w
    dcum = e.sum(-1) - e.sum(-2)
    # inter-chunk term exp(cum) C h_c
    ecum = torch.exp(cum)
    dc = dc + ecum[..., None] * (dyc @ h_in.transpose(-1, -2))
    dcum = dcum + ecum * (dyc * (cc @ h_in)).sum(-1)
    direct = cc.transpose(-1, -2) @ (ecum[..., None] * dyc)     # (BH,C,N,P)
    # the state's gradient, one reverse pass: g[:, c] is dL/dh_{c+1}
    decay = torch.exp(total)
    g_next = (torch.zeros((bh, n, p), dtype=torch.float32, device=x.device)
              if dh is None else dh.float())
    g = [None] * nc
    for ci in reversed(range(nc)):
        g[ci] = g_next
        g_next = direct[:, ci] + decay[:, ci, None, None] * g_next
    g = torch.stack(g, 1)
    # the chunk's state S_c and the decay of h_c
    suffix = torch.exp(total[..., None] - cum)
    sw = suffix * dtc
    gx = xc @ g.transpose(-1, -2)                               # (BH,C,Q,N)
    db = db + sw[..., None] * gx
    dx = dx + sw[..., None] * (bc @ g)
    ds = (bc * gx).sum(-1)
    ddt = ddt + ds * suffix
    dcum = dcum - ds * sw
    dtotal = (ds * sw).sum(-1) + decay * (h_in * g).sum((-1, -2))
    dcum[..., -1] += dtotal
    # cum = cumsum(dt a)
    rcum = dcum.flip(-1).cumsum(-1).flip(-1)
    ddt = ddt + a[:, None, None] * rcum
    da = (dtc * rcum).sum((1, 2))
    return (dx.reshape(bh, l, p), ddt.reshape(bh, l), da,
            db.reshape(bh, l, n), dc.reshape(bh, l, n))


@torch.library.custom_op("repro_torch::ssd_scan_bwd", mutates_args=())
def _ssd_bwd_op(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, h_in: torch.Tensor,
                dy: torch.Tensor, dh: torch.Tensor | None, chunk: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor, torch.Tensor]:
    """``_ssd_bwd`` as an operator, so that a fake-tensor trace sees one op
    with its shapes and flop count."""
    return _ssd_bwd(x, dt, a, b, c, h_in, dy, dh, chunk)


@_ssd_bwd_op.register_fake
def _(x, dt, a, b, c, h_in, dy, dh, chunk):
    return (torch.empty_like(x), torch.empty_like(dt), torch.empty_like(a),
            torch.empty_like(b), torch.empty_like(c))


@register_flop_formula(torch.ops.repro_torch.ssd_scan_bwd)
def _(x_shape, dt_shape, a_shape, b_shape, c_shape, h_shape, dy_shape,
      dh_shape, chunk, *args, out_shape=None, **kwargs) -> int:
    """Operations of ``_ssd_bwd``'s products a (row, chunk), an FMA being
    2: five of Q x Q pairs (C B^T, dW, dX of depth P; dC, dB of depth N),
    five of Q x N x P (the inter-chunk and state terms)."""
    bh, l, p = x_shape
    n = b_shape[-1]
    return bh * (l // chunk) * (2 * chunk * chunk * (3 * n + 2 * p)
                                + 10 * chunk * n * p)


class _SSDScan(torch.autograd.Function):
    """The scan's forward by the kernels (``ssd_scan``, which also returns
    the chunks' incoming states), ``_ssd_bwd``'s backward. Returns y, or
    (y, h_final) with ``final_state``."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk: int, final_state: bool):
        out = ssd_kernel.ssd_scan(x, dt, a, b, c, chunk=chunk,
                                  final_state=final_state, chunk_states=True)
        ctx.save_for_backward(x, dt, a, b, c, out[-1])
        ctx.chunk = chunk
        return out[:2] if final_state else out[0]

    @staticmethod
    def backward(ctx, dy, dh=None):
        x, dt, a, b, c, h_in = ctx.saved_tensors
        return (*_ssd_bwd_op(x, dt, a, b, c, h_in, dy, dh, ctx.chunk), None,
                None)


def _sharded_ssd(x, dt, a, bmat, cmat, chunk: int, final_state: bool):
    """``_ssd_chunked`` of DTensors: each rank scans its shard, batch on
    the dp axes and heads on tp (``local_map``), so the kernels' (B·H, S,
    ...) layout and the per-head copies of B and C are made of the local
    batch rows and heads."""
    xp = site_placements(x, "dp", None, "tp", None)
    # x's placement on each mesh dim decides the others'
    rule = {Shard(0): (Shard(0), Replicate(), Shard(0), Shard(0)),
            Shard(2): (Shard(2), Shard(0), Replicate(), Shard(1))}
    rep = (Replicate(),) * 4
    dtp, ap, bcp, hp = (tuple(rule.get(p, rep)[j] for p in xp)
                        for j in range(4))
    x, dt, a, bmat, cmat = (t.redistribute(t.device_mesh, pl) for t, pl in (
        (x, xp), (dt, dtp), (a, ap), (bmat, bcp), (cmat, bcp)))

    def local(*args):
        y, h = _ssd_chunked(*args, chunk, final_state)
        return (y, h) if final_state else y

    out = summed_map(local, out_placements=(list(xp), list(hp))
                     if final_state else list(xp),
                     in_placements=tuple(map(list, (xp, dtp, ap, bcp, bcp))))(
        x, dt, a, bmat, cmat)
    return out if final_state else (out, None)


def _ssd_chunked(x, dt, a, bmat, cmat, chunk: int,
                 final_state: bool = True) -> tuple:
    """Chunked SSD scan, one ``ssd_scan`` call (through ``_SSDScan`` when
    an input needs a gradient; DTensors through ``_sharded_ssd``, one
    call a rank).

    x: (B, S, H, P); dt: (B, S, H); a: (H,) negative; b/c: (B, S, N).
    Returns (y, h_final) with y like x, h (B, H, N, P) fp32, or None
    without ``final_state``.
    """
    if isinstance(x, DTensor):
        return _sharded_ssd(x, dt, a, bmat, cmat, chunk, final_state)
    bsz, s, nh, p = x.shape
    n = bmat.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} must be chunk-padded (chunk {chunk})")

    def per_head(t: torch.Tensor) -> torch.Tensor:  # (B, S, N) -> (B·H, S, N)
        return t.float()[:, None].expand(bsz, nh, s, n).reshape(
            bsz * nh, s, n).contiguous()  # at B = 1 a reshape is a view

    args = (
        x.float().permute(0, 2, 1, 3).reshape(bsz * nh, s, p).contiguous(),
        dt.float().permute(0, 2, 1).reshape(bsz * nh, s).contiguous(),
        a.float().repeat(bsz), per_head(bmat), per_head(cmat))
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        out = _SSDScan.apply(*args, chunk, final_state)
    else:
        out = ssd_kernel.ssd_scan(*args, chunk=chunk,
                                  final_state=final_state)
    y, h = out if final_state else (out, None)
    y = y.reshape(bsz, nh, s, p).permute(0, 2, 1, 3).to(x.dtype)
    return y, None if h is None else h.reshape(bsz, nh, n, p)


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
        """Full-sequence (training, prefill) path, ``apply_mamba``. x:
        (B, S, D).

        Returns ``(out, None)``, or with ``return_cache`` ``(out,
        (conv_state, ssm_state))`` for decode continuation: the last
        (conv_width-1) raw xBC inputs and the final SSD state."""
        cfg = self.cfg
        d_in, nh, hd, n = dims(cfg)
        dt_ = x.dtype
        x = annotate(x, "dp", None, None)  # whole sequences (2d_seq)
        proj = annotate(matmul_tp(x, gathered(self.in_proj.to(dt_), x)), "dp",
                        None, "tp")
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
        xh = split_last(xs, nh, hd)
        y, h_final = _ssd_chunked(xh, dt, a, bmat, cmat, chunk,
                                  final_state=return_cache)
        y = y + self.D.to(y.dtype)[None, None, :, None] * xh  # skip
        y = merge_last(y)[:, :s]
        y = rmsnorm(y * F.silu(z), self.gate_norm)            # gated norm
        out = y @ gathered(self.out_proj.to(dt_), y)
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
        proj = annotate(matmul_tp(x[:, 0], gathered(self.in_proj.to(dt_), x)),
                        "dp", "tp")                           # (B, ...)
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
        xh = split_last(xs, nh, hd).float()                  # (B,H,P)
        decay = torch.exp(dt * a)                               # (B,H)
        h = (decay[:, :, None, None] * ssm
             + dt[:, :, None, None] * bvec[:, None, :, None]
             * xh[:, :, None, :])
        y = torch.einsum("bhnp,bn->bhp", h, cvec) + self.D[None, :, None] * xh
        y = merge_last(y).to(dt_)
        y = rmsnorm(y * F.silu(z), self.gate_norm)
        out = (y @ gathered(self.out_proj.to(dt_), y))[:, None, :]
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

"""GQA attention: flash-attention kernel forward with the reference's
backward, plain decode.

Port of ``src/repro/models/attention.py``. The reference's
``blockwise_attention`` is FlashAttention in plain JAX (a ``lax.scan``
over kv blocks, ``:87``, under a custom VJP); here it is the call site
of the port's hand-written kernel, ``kernels.flash_attention``: the
reference layout (B, Sq, H, D) goes to the kernel's (B·H, Sq, D), and
k/v (B, Skv, Hkv, D) to (B·Hkv, Skv, D), so query row ``b·H + h`` reads
kv row ``(b·H + h) // group = b·Hkv + h // group``, the kernel's GQA
rule. Skv may differ from Sq (cross-attention to an encoder's output)
when no causal or window mask is asked for. Queries are padded up to a
multiple of their tile and keys to a multiple of theirs, the result
sliced back to Sq, and the kernel is told the real key count
(``kv_len`` = Skv), so it masks the pad keys as the reference's scan
masks its pad (``:72-73``): a padded call is exact with or without a
causal mask. Tiling: ``TILE``, or ``SHORT_TILE`` for a length shorter
than it, for queries and keys apart (a fixed default; serving a tuned
tiling from a recording is later work). A tiling the kernel refuses
raises ``ConfigRejected``; nothing falls back to the plain version,
which runs only for tensors on the CPU (the wrapper's own dispatch).

Training: the reference's custom VJP (``_flash`` / ``_flash_fwd`` /
``_flash_bwd``, ``:96-161``) is the ``torch.autograd.Function``
``_Flash``. Its forward is the kernel, asked also for each q row's
logsumexp, and saves (q, k, v, out, lse), linear in S; its backward is
``_flash_bwd``, the reference's algorithm in PyTorch (the reference has
no Pallas backward): delta = sum(dout * out), then for each block of
``BWD_BLOCK_KV`` keys the probabilities p = exp(s - lse) recomputed
under the same mask, dv, dp, ds = p (dp - delta) scale, dq and dk, in
float32, dk and dv summed over each GQA group. Its key blocks end at
``kv_len``: the pad keys' p is 0, so their dk and dv stay 0 and the
gradient of the pad is cut off by ``F.pad``'s. It visits only the q rows
that see some key of the block (from the block's first key on under the
causal mask, up to its last key plus the window under a window, all of
Sq otherwise): the rows it skips have p = 0 exactly. A call whose
inputs need no gradient (serving) goes straight to the kernel and asks
for no lse.

What changed: the reference's per-layer ``is_global`` flag becomes the
caller's choice of ``window`` (None on a global layer, the config's
window on a local one), the mask ``_mask_for`` builds; ``q_offset`` (0
on every prefill and training step) is left out. The kernel keeps the
probabilities in float32 for the PV product where the reference casts
them to bf16 first (``:79``), so the two differ at bf16 level.
``attention_reference`` and ``decode_attention`` are plain PyTorch, as
the reference computes them outside any kernel.

DTensors (the dry run's fake world, phase 12's one-rank mesh): the
kernel runs rank by rank on each shard (``local_map``), batch rows on the
dp axes and q heads on tp, so its (B·H, S, D) reshape, which merges a
dp-sharded with a tp-sharded dim, happens on local tensors; kv heads
that do not divide as q's do are held whole and each rank slices the
ones its q heads read. ``_flash_bwd`` is also the operator
``repro_torch::flash_attention_bwd`` (shapes and a flop count for fake
tensors). ``decode_attention`` of DTensor caches runs on the caches'
shards: a head-dim shard sums its partial scores by an all-reduce, a
sequence shard (context parallelism) combines each rank's max, sum and
weighted values by all-reduces; with neither, each rank calls
``decode_attention`` itself.
"""
from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.flop_counter import register_flop_formula

from ..distribution.annotate import site_placements
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


def _flash_bwd(q, k, v, out, lse, dout, *, causal: bool, window,
               kv_len: int | None = None) -> tuple:
    """The reference's ``_flash_bwd`` on the kernel's layout: q, out, dout
    (BH, Sq, D), k/v (BH_kv, Skv, D) of which the first ``kv_len``
    (default Skv) are real, lse (BH, Sq) float32. Returns (dq, dk, dv) in
    the inputs' dtypes, dk and dv 0 on the pad keys."""
    bh, sq, d = q.shape
    bh_kv, skv = k.shape[:2]
    kv_len = skv if kv_len is None else kv_len
    g = bh // bh_kv
    scale = d ** -0.5
    qg = q.float().reshape(bh_kv, g, sq, d)
    dog = dout.float().reshape(bh_kv, g, sq, d)
    # D_i = sum_d dout * out (the flash backward trick)
    delta = (dog * out.float().reshape(bh_kv, g, sq, d)).sum(-1)
    lse = lse.reshape(bh_kv, g, sq)
    pos = torch.arange(max(sq, skv), device=q.device)
    dq = torch.zeros_like(qg)
    dk = torch.zeros((bh_kv, skv, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for k0 in range(0, kv_len, BWD_BLOCK_KV):   # no block of pad alone
        k1 = min(k0 + BWD_BLOCK_KV, kv_len)    # the real keys kv_pos < kv_len
        q0 = k0 if causal else 0            # rows that see a key of the block
        q1 = sq if window is None else min(sq, k1 - 1 + window)
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
    return (dq.reshape(bh, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                  causal: bool, window: int, kv_len: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_flash_bwd`` as an operator (``window`` -1 is none), so that a
    fake-tensor trace sees one op with its shapes and flop count."""
    return _flash_bwd(q, k, v, out, lse, dout, causal=causal,
                      window=None if window < 0 else window, kv_len=kv_len)


@_flash_bwd_op.register_fake
def _(q, k, v, out, lse, dout, causal, window, kv_len):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def bwd_flops(bh: int, sq: int, d: int, causal: bool, window, kv_len: int
              ) -> int:
    """Operations of ``_flash_bwd``: five products of depth d (scores, dv,
    dp, dq, dk) over the (q row, key) pairs of each key block's visited
    rows, an FMA being 2."""
    pairs = 0
    for k0 in range(0, kv_len, BWD_BLOCK_KV):
        k1 = min(k0 + BWD_BLOCK_KV, kv_len)
        q0 = k0 if causal else 0
        q1 = sq if window is None else min(sq, k1 - 1 + window)
        pairs += max(q1 - q0, 0) * (k1 - k0)
    return 10 * bh * d * pairs


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _(q_shape, k_shape, v_shape, out_shape_, lse_shape, dout_shape, causal,
      window, kv_len, *args, out_shape=None, **kwargs) -> int:
    bh, sq, d = q_shape
    return bwd_flops(bh, sq, d, causal, None if window < 0 else window,
                     kv_len)


class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: the kernel's forward (with
    its lse), ``_flash_bwd``'s backward."""

    @staticmethod
    def forward(ctx, q, k, v, block_q: int, block_kv: int, causal: bool,
                window, kv_len: int):
        out, lse = fa.flash_attention(q, k, v, block_q=block_q,
                                      block_kv=block_kv, causal=causal,
                                      window=window, return_lse=True,
                                      kv_len=kv_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.kv_len = causal, window, kv_len
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_flash_bwd_op(q, k, v, out, lse, dout, ctx.causal,
                               -1 if ctx.window is None else ctx.window,
                               ctx.kv_len),
                None, None, None, None, None)


def _tile(s: int) -> int:
    return TILE if s >= TILE else SHORT_TILE


def _kv_heads(coord: int, hq_local: int, group: int):
    """The kv heads rank ``coord`` of a head-sharded q reads, for kv heads
    held whole: a slice when its q heads fall into whole groups, else one
    kv head a q head (group 1)."""
    idx = [(coord * hq_local + i) // group for i in range(hq_local)]
    n_kv = idx[-1] - idx[0] + 1
    if hq_local % n_kv == 0 and all(
            j == idx[0] + i // (hq_local // n_kv) for i, j in enumerate(idx)):
        return slice(idx[0], idx[-1] + 1)
    return idx


def _sharded_attention(q, k, v, causal, window):
    """``blockwise_attention`` of DTensors: each rank runs the kernel on
    its shard, batch on the dp axes and q heads on tp (``local_map``), so
    the kernels' (B·H, S, D) reshape happens on local tensors. k and v
    share q's batch placements; they are head-sharded only where their
    heads divide as q's do, else held whole and sliced to the kv heads
    this rank's q heads read."""
    qp = site_placements(q, "dp", None, "tp", None)
    kvp, tp_dims = [], []
    for i, p in enumerate(qp):
        if p == Shard(2):
            tp_dims.append(i)
    n_tp = 1
    for i in tp_dims:
        n_tp *= q.device_mesh.size(i)
    h, hkv = q.shape[2], k.shape[2]
    kv_sharded = hkv % n_tp == 0
    for p in qp:
        kvp.append(p if p != Shard(2) or kv_sharded else Replicate())
    kvp = tuple(kvp)
    sel = None
    if tp_dims and not kv_sharded:
        coord = 0
        mine = q.device_mesh.get_coordinate()
        for i in tp_dims:
            coord = coord * q.device_mesh.size(i) + mine[i]
        sel = _kv_heads(coord, h // n_tp, h // hkv)

    def local(ql, kl, vl):
        if sel is not None:
            kl, vl = kl[:, :, sel], vl[:, :, sel]
        return blockwise_attention(ql, kl, vl, causal=causal, window=window)

    q, k, v = (t.redistribute(t.device_mesh, pl)
               for t, pl in ((q, qp), (k, kvp), (v, kvp)))
    # local_map: a list of placements a tensor, a tuple of them a call
    return local_map(local, out_placements=list(qp),
                     in_placements=(list(qp), list(kvp), list(kvp)))(q, k, v)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int | None = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D), Skv == Sq under a causal
    or window mask. Returns (B, Sq, H, D), one ``flash_attention`` call;
    through ``_Flash`` (differentiable) when an input needs a gradient.
    DTensors go through ``_sharded_attention``: one call a rank on its
    shard."""
    if isinstance(q, DTensor):
        return _sharded_attention(q, k, v, causal, window)
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1:3]
    if (causal or window is not None) and sq != skv:
        raise ValueError(f"a causal or window mask needs as many queries as "
                         f"keys, got {sq} and {skv}")
    tile_q, tile_kv = _tile(sq), _tile(skv)

    def heads_first(t: torch.Tensor, n: int, tile: int) -> torch.Tensor:
        s = t.shape[1]
        t = t.permute(0, 2, 1, 3)
        if s % tile:
            t = F.pad(t, (0, 0, 0, (-s) % tile))
        return t.reshape(b * n, t.shape[2], d).contiguous()

    args = (heads_first(q, h, tile_q), heads_first(k, hkv, tile_kv),
            heads_first(v, hkv, tile_kv))
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        out = _Flash.apply(*args, tile_q, tile_kv, causal, window, skv)
    else:
        out = fa.flash_attention(*args, block_q=tile_q, block_kv=tile_kv,
                                 causal=causal, window=window, kv_len=skv)
    return out.reshape(b, h, -1, d)[:, :, :sq].permute(0, 2, 1, 3)


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


def _sharded_decode(q, k_cache, v_cache, cache_len, window):
    """``decode_attention`` of DTensor caches, rank by rank on the caches'
    own shards (``local_map``; q and the output are laid out to match):
    batch rows on dp, kv heads on tp, or the head dim on tp (each rank's
    partial scores summed by an all-reduce before the softmax), or the
    sequence on dp (context parallelism: each rank's max, sum and
    weighted values combined by all-reduces, the softmax of the whole
    row without gathering the cache). With none of the last two the
    local call is ``decode_attention`` itself."""
    mesh, cp = k_cache.device_mesh, tuple(k_cache.placements)
    as_q = {0: Shard(0), 2: Shard(2), 3: Shard(3)}  # cache dim -> q's
    qp = tuple(as_q.get(p.dim, Replicate()) if isinstance(p, Shard)
               else Replicate() for p in cp)
    head_dims = [i for i, p in enumerate(cp) if p == Shard(3)]
    seq_dims = [i for i, p in enumerate(cp) if p == Shard(1)]
    if not isinstance(cache_len, DTensor):
        cache_len = DTensor.from_local(
            torch.as_tensor(cache_len, device=q.device.type).broadcast_to(
                q.shape[:1]).contiguous(), mesh, (Replicate(),) * mesh.ndim,
            run_check=False)
    lp = tuple(Shard(0) if p == Shard(0) else Replicate() for p in cp)
    d = q.shape[-1]
    s_local = k_cache.shape[1]
    coord = 0
    for i in seq_dims:
        coord = coord * mesh.size(i) + mesh.get_coordinate()[i]
        s_local //= mesh.size(i)

    def local(ql, kl, vl, cl):
        if not head_dims and not seq_dims:
            return decode_attention(ql, kl, vl, cl, window=window)
        b, _, h, dl = ql.shape
        hkv = kl.shape[2]
        qg = ql.reshape(b, hkv, h // hkv, dl)
        s = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                         kl.float()) * (d ** -0.5)
        for i in head_dims:
            s = funcol.all_reduce(s, "sum", (mesh, i))
        kv_pos = coord * s_local + torch.arange(s_local, device=ql.device)
        valid = kv_pos[None, :] < cl[:, None]
        if window is not None:
            valid &= (cl[:, None] - 1 - kv_pos[None, :]) < window
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
        m = s.amax(-1, keepdim=True)
        for i in seq_dims:
            m = funcol.all_reduce(m, "max", (mesh, i))
        e = torch.exp(s - m)
        total = e.sum(-1, keepdim=True)
        o = torch.einsum("bkgs,bskd->bkgd", e.to(vl.dtype).float(),
                         vl.float())
        for i in seq_dims:
            total = funcol.all_reduce(total, "sum", (mesh, i))
            o = funcol.all_reduce(o, "sum", (mesh, i))
        return (o / total).reshape(b, 1, h, dl).to(ql.dtype)

    q = q.redistribute(mesh, qp)
    cache_len = cache_len.redistribute(mesh, lp)
    out = local_map(local, out_placements=list(qp),
                    in_placements=(list(qp), list(cp), list(cp), list(lp)))(
        q, k_cache, v_cache, cache_len)
    # whole heads again: a head-dim shard cannot merge into (H·D)
    return out.redistribute(mesh, tuple(Replicate() if p == Shard(3) else p
                                        for p in qp))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     window: int | None = None) -> torch.Tensor:
    """Single-step attention against a cache.

    q: (B, 1, H, D); caches: (B, S_max, Hkv, D); cache_len: (B,) or scalar —
    number of valid cache entries *including* the current token. Products
    sum in float32 from the compute-dtype operands, as the reference's
    ``preferred_element_type=float32`` einsums do. DTensor caches go
    through ``_sharded_decode``.
    """
    if isinstance(k_cache, DTensor):
        return _sharded_decode(q, k_cache, v_cache, cache_len, window)
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

"""Model composition for every family of the reference.

Port of ``src/repro/models/transformer.py``. Families and their stacks:

  dense / vlm  [attn + mlp] × L  (gemma3: a per-layer global flag switches
                                  the mask's window off, not the code;
                                  qwen2-vl: patch embeddings replace the
                                  first tokens' embeddings, M-RoPE
                                  positions (B, S, 3) from the batch)
  moe     [attn + moe] × L
  ssm     [mamba2] × L
  hybrid  ([mamba2] × k + shared attn block) × groups + tail
          (zamba2: one shared transformer block reused at every site)
  audio   whisper enc-dec: encoder [bi-attn + mlp] × Le over stub audio
          embeddings; decoder [self-attn + cross-attn + mlp] × Ld

Entry points, with the reference's names and arguments:
  ``init_params``                      the ``Model`` (fp32 weights)
  ``forward``                          teacher-forced logits (training;
                                       ``remat``, ``pre_logits``)
  ``init_cache`` / ``prefill`` / ``decode_step``   serving

What changed:

  * Parameters are a ``Model`` of ``nn.Module`` blocks (``Block``,
    ``MambaBlock``, each with ``forward``, ``prefill`` and ``decode``),
    and layers run as a Python loop over them, not a ``lax.scan`` over
    stacked parameters. Caches keep the reference's stacked layout
    (``weights.from_reference`` maps the parameters).
  * Full-sequence attention (training, prefill; the encoder's and the
    cross-attention too, over the encoder's frames padded to the tile
    and masked past their count) goes through the flash-attention kernel
    and every Mamba layer through the SSD kernels (``attention.py``,
    ``mamba2.py``, each with the reference's backward in PyTorch);
    decode is plain PyTorch, as in the reference, the cross-attention
    reading the whole static encoder cache. The MoE dispatch is plain
    PyTorch too (``mlp.py``), as the reference computes it.
  * ``remat`` wraps each rematerialised layer body in
    ``torch.utils.checkpoint`` (non-reentrant): ``"full"`` recomputes the
    whole body in the backward, ``"dots"`` keeps the outputs of its
    products (``aten.mm`` / ``aten.addmm``, the counterpart of
    ``checkpoint_dots_with_no_batch_dims``) and recomputes the rest. As in
    the reference it covers the decoder's layers (dense, moe, vlm,
    audio) and Mamba layers, never the hybrid's shared block nor the
    audio encoder. A recompute launches the kernels again.
  * ``decode_step`` writes the new token's k/v and Mamba states into the
    cache in place and returns it (copying a (B, max_len) cache every
    token would double decode's bytes); ``prefill`` computes the logits
    of the last position only, the one it returns, and projects only k
    and v of the audio cross-attention's static cache (the reference
    also computes a q it drops).
  * ``init_params`` takes a ``torch.Generator`` and a device (the card
    unless ``"cpu"`` is asked for); the weights are trainable
    parameters.
  * Distribution: the reference's ``annotate`` pins stand where it has
    them (q, k, v after their projections, each block's input, the
    embedded tokens); DTensor parameters (``distribution.sharding``)
    run the same code. What DTensor needs beyond the pins: each weight's
    FSDP shard gathered where a product uses it (``gathered``; the
    unembedding's contraction split over a model axis its vocab does not
    divide, ``matmul_tp``), sequences gathered before each projection
    and each sublayer's output pinned as the residual stream before its
    add, in decode too (``residual``: under 2d_seq a reduce-scatter into
    the sequence shard, its gradient gathered whole before the
    products; GSPMD places these itself), heads split and merged only
    along whole-head shards, and in full-sequence attention, heads a
    model axis does not divide sharded by whole heads, unevenly, as
    GSPMD pads them (``project_heads``, ``project_from_heads``),
    positions laid out as the batch rows (``rows_like``), a
    vocab-parallel embedding lookup, on the table's width shard in
    decode (``_embed_sharded``), decode's unembedding split over the
    table's shards (``product``), prefill's cache made as
    sharded zeros, decode's cache writes rank by rank (``_write_kv``),
    and every call site run rank by rank summing its replicated inputs'
    gradients over the ranks (``summed_map``).
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import cuda
from ..configs.base import ArchConfig
from ..distribution.annotate import (annotate, current_layout, gathered,
                                     pin_grad, product, project_from_heads,
                                     project_heads, reinstall, residual,
                                     rows_like, shard_to_rows,
                                     site_placements, summed_map)
from ..distribution.sharding import cache_shardings, sharded_zeros
from .attention import blockwise_attention, decode_attention
from .layers import (COMPUTE_DTYPE, Norm, apply_rope, dense_init,
                     embed_init, param, rope_angles, softcap)
from .mamba2 import Mamba, init_mamba_cache
from .mlp import MLP, MoE

CACHE_DTYPE = torch.bfloat16
FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
# families whose layers are attention blocks with a kv cache each
ATTENTION_STACKS = ("dense", "moe", "vlm", "audio")


# ----------------------------------------------------------------- attention
class Attention(nn.Module):
    """``make_attention`` + ``apply_attention`` (prefill, through the
    kernel) + ``apply_attention_decode`` (plain)."""

    def __init__(self, cfg: ArchConfig, gen=None, device=None):
        super().__init__()
        self.cfg = cfg
        d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        self.wq = param(dense_init(gen, d, h * dh, device=device))
        self.wk = param(dense_init(gen, d, hkv * dh, device=device))
        self.wv = param(dense_init(gen, d, hkv * dh, device=device))
        self.wo = param(dense_init(gen, h * dh, d, scale=(h * dh) ** -0.5,
                                   device=device))

    def _project_q(self, x: torch.Tensor, uneven: bool = False
                   ) -> torch.Tensor:
        x = annotate(x, "dp", None, None)  # whole sequences (2d_seq)
        return project_heads(x, self.wq.to(x.dtype), self.cfg.n_heads,
                             self.cfg.d_head, uneven)

    def project_kv(self, src: torch.Tensor, uneven: bool = False) -> tuple:
        """k and v of ``src`` (B, Skv, D), each (B, Skv, Hkv, Dh), without
        RoPE: the audio cross-attention's static cache. With ``uneven``,
        kv heads as many as q's go on a tensor-parallel axis that does
        not divide them as q's go (``project_heads``); fewer are held
        whole there."""
        cfg = self.cfg
        src = annotate(src, "dp", None, None)  # whole sequences (2d_seq)
        dt = src.dtype
        uneven = uneven and cfg.n_kv_heads == cfg.n_heads
        return tuple(project_heads(src, w.to(dt), cfg.n_kv_heads, cfg.d_head,
                                   uneven) for w in (self.wk, self.wv))

    def forward(self, x, positions, *, causal=True, window=None, rope=True,
                kv_src=None) -> tuple:
        """Full-sequence attention. x: (B,S,D); positions: (B,S[,3]); k
        and v from ``kv_src`` (B,Skv,D) where given (cross-attention,
        which takes no RoPE). Returns (out, (k, v)), k after RoPE. Heads
        that a tensor-parallel axis does not divide go on it unevenly,
        whole heads a rank (``project_heads``)."""
        if rope and kv_src is not None:
            raise ValueError("cross-attention (kv_src) takes no RoPE")
        q = self._project_q(x, True)
        k, v = self.project_kv(x if kv_src is None else kv_src, True)
        if rope:
            ang = rope_angles(self.cfg, positions)
            q = apply_rope(q, ang)
            k = apply_rope(k, ang)
        out = blockwise_attention(q, k, v, causal=causal, window=window)
        return project_from_heads(out, self.wo.to(x.dtype)), (k, v)

    def decode(self, x, cache_k, cache_v, idx, *, window=None, rope=True,
               cross=False):
        """Single step. x: (B,1,D); caches (B,Smax,Hkv,Dh). Self-attention
        writes the current token's k/v into them at the positions ``idx``
        (B,), on x's device, in place; cross-attention (``cross``) reads
        the whole static encoder cache."""
        cfg = self.cfg
        b = x.shape[0]
        q = self._project_q(x)
        k, v = (None, None) if cross else self.project_kv(x)
        if rope:
            pos = rows_like(idx[:, None], x)
            if cfg.m_rope:
                pos = pos[..., None].expand(b, 1, 3)
            ang = rope_angles(cfg, pos)
            q = apply_rope(q, ang)
            if not cross:
                k = apply_rope(k, ang)
        if cross:
            total_len = cache_k.shape[1]  # the whole encoder output
        else:
            _write_kv(cache_k, cache_v, k[:, 0], v[:, 0], idx)
            total_len = idx + 1
        out = decode_attention(q, cache_k.to(q.dtype), cache_v.to(q.dtype),
                               total_len, window=window)
        out = out.reshape(b, 1, -1)
        return out @ gathered(self.wo.to(x.dtype), out)


def _write_kv(cache_k, cache_v, k, v, idx) -> None:
    """Write one step's k and v (B, Hkv, Dh) into the caches (B, Smax,
    Hkv, Dh) at the positions ``idx`` (B,), in place. DTensor caches are
    written rank by rank into the local shards: k and v are laid out as
    the caches' batch and head dims, and where the sequence is sharded
    (context parallelism) each rank rewrites the one slot ``idx`` clamps
    to in its slice, with the new value only where ``idx`` falls in it,
    so no value decides which rank writes."""
    if not isinstance(cache_k, DTensor):
        rows = torch.arange(k.shape[0], device=k.device)
        cache_k[rows, idx] = k.to(cache_k.dtype)
        cache_v[rows, idx] = v.to(cache_v.dtype)
        return
    mesh, cp = cache_k.device_mesh, cache_k.placements
    # cache dim d -> the step's dim (B, Hkv, Dh lose the sequence)
    step_dim = {0: 0, 2: 1, 3: 2}
    kp = tuple(Shard(step_dim[p.dim]) if isinstance(p, Shard)
               and p.dim != 1 else Replicate() for p in cp)
    ip = tuple(p if p == Shard(0) else Replicate() for p in cp)
    k, v = (t.redistribute(mesh, kp).to_local() for t in (k, v))
    if not isinstance(idx, DTensor):
        idx = DTensor.from_local(idx, mesh, (Replicate(),) * mesh.ndim,
                                 run_check=False)
    idx = idx.redistribute(mesh, ip).to_local()
    ck, cv = cache_k.to_local(), cache_v.to_local()
    s_local = ck.shape[1]
    coord, seq_dims = 0, [i for i, p in enumerate(cp) if p == Shard(1)]
    for i in seq_dims:
        coord = coord * mesh.size(i) + mesh.get_coordinate()[i]
    pos = idx - coord * s_local
    inside = ((pos >= 0) & (pos < s_local))[:, None, None]
    pos = pos.clamp(0, s_local - 1)
    rows = torch.arange(ck.shape[0], device=ck.device)
    for cache, new in ((ck, k), (cv, v)):
        cache[rows, pos] = torch.where(inside, new.to(cache.dtype),
                                       cache[rows, pos])


# -------------------------------------------------------------- layer bodies
class Block(nn.Module):
    """An attention block: attention, then the MLP (kind ``dense``, also
    the audio encoder's ``bidi`` blocks, run unmasked) or the ``MoE``
    (kind ``moe``), each behind its norm; kind ``encdec`` (the audio
    decoder) adds cross-attention to the encoder's output behind
    ``norm_x``, between the two."""

    def __init__(self, cfg: ArchConfig, gen=None, device=None,
                 kind: str = "dense"):
        super().__init__()
        self.norm1 = Norm(cfg, cfg.d_model, device)
        self.attn = Attention(cfg, gen, device)
        self.norm2 = Norm(cfg, cfg.d_model, device)
        self.moe = MoE(cfg, gen, device) if kind == "moe" else None
        self.mlp = (None if kind == "moe"
                    else MLP(cfg, cfg.d_model, cfg.d_ff, gen, device))
        cross = kind == "encdec"
        self.norm_x = Norm(cfg, cfg.d_model, device) if cross else None
        self.xattn = Attention(cfg, gen, device) if cross else None

    def _ffn(self, x):
        z = self.norm2(x)
        return x + residual(self.mlp(z) if self.moe is None else self.moe(z))

    def _body(self, x, positions, window, causal, enc_out) -> tuple:
        x = annotate(x, "dp", "sp", None)
        h, kv = self.attn(self.norm1(x), positions, causal=causal,
                          window=window)
        x = x + residual(h)
        if self.xattn is not None:
            h, _ = self.xattn(self.norm_x(x), positions, causal=False,
                              rope=False, kv_src=enc_out)
            x = x + residual(h)
        return self._ffn(x), kv

    def prefill(self, x, positions, *, window=None, enc_out=None) -> tuple:
        """(x, (k, v)) with k/v in the cache dtype."""
        x, (k, v) = self._body(x, positions, window, True, enc_out)
        return x, (k.to(CACHE_DTYPE), v.to(CACHE_DTYPE))

    def forward(self, x, positions, *, window=None, causal=True,
                enc_out=None):
        return self._body(x, positions, window, causal, enc_out)[0]

    def decode(self, x, cache_k, cache_v, idx, *, window=None, cross=None):
        """``cross``: this layer's static (xk, xv) encoder cache."""
        x = x + residual(self.attn.decode(self.norm1(x), cache_k, cache_v,
                                          idx, window=window))
        if self.xattn is not None:
            x = x + residual(self.xattn.decode(self.norm_x(x), *cross, idx,
                                               rope=False, cross=True))
        return self._ffn(x)


class MambaBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, gen=None, device=None):
        super().__init__()
        self.norm = Norm(cfg, cfg.d_model, device)
        self.mamba = Mamba(cfg, gen, device)

    def prefill(self, x) -> tuple:
        """(x, (conv_state, ssm_state))."""
        x = annotate(x, "dp", "sp", None)
        h, cache = self.mamba(self.norm(x), return_cache=True)
        return x + residual(h), cache

    def forward(self, x):
        x = annotate(x, "dp", "sp", None)
        return x + residual(self.mamba(self.norm(x))[0])

    def decode(self, x, conv, ssm) -> tuple:
        h, conv, ssm = self.mamba.decode(conv, ssm, self.norm(x))
        return x + residual(h), conv, ssm


# ---------------------------------------------------------------------- model
class Model(nn.Module):
    """The parameters of one config, named as the reference's pytree:
    ``embed``, ``final_norm``, ``unembed`` (untied only), and ``layers``
    (dense, vlm, moe, ssm; audio: the decoder, after ``encoder`` and
    ``enc_norm``) or ``mamba_groups`` ([n_groups][every]), ``mamba_tail``
    and ``shared`` (hybrid)."""

    def __init__(self, cfg: ArchConfig, gen=None, device=None):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
        self.cfg = cfg
        self.embed = param(embed_init(gen, cfg.vocab, cfg.d_model, device))
        self.final_norm = Norm(cfg, cfg.d_model, device)
        self.unembed = (None if cfg.tie_embeddings else param(
            dense_init(gen, cfg.d_model, cfg.vocab, device=device)))

        def stack(n, kind):
            return nn.ModuleList(Block(cfg, gen, device, kind)
                                 for _ in range(n))

        if cfg.family in ("dense", "vlm"):
            self.layers = stack(cfg.n_layers, "dense")
        elif cfg.family == "moe":
            self.layers = stack(cfg.n_layers, "moe")
        elif cfg.family == "audio":
            self.encoder = stack(cfg.n_encoder_layers, "dense")  # bidi
            self.enc_norm = Norm(cfg, cfg.d_model, device)
            self.layers = stack(cfg.n_layers, "encdec")
        elif cfg.family == "ssm":
            self.layers = nn.ModuleList(MambaBlock(cfg, gen, device)
                                        for _ in range(cfg.n_layers))
        else:
            every = cfg.shared_attn_every
            n_groups, tail = divmod(cfg.n_layers, every)
            self.mamba_groups = nn.ModuleList(
                nn.ModuleList(MambaBlock(cfg, gen, device)
                              for _ in range(every))
                for _ in range(n_groups))
            self.mamba_tail = nn.ModuleList(MambaBlock(cfg, gen, device)
                                            for _ in range(tail))
            self.shared = Block(cfg, gen, device)


def init_params(cfg: ArchConfig, generator: torch.Generator | None = None,
                *, device=None) -> Model:
    """A ``Model`` of ``cfg`` on ``device`` (the card unless ``"cpu"`` is
    asked for; raises without CUDA otherwise), drawn from ``generator``
    (default: seed 0 on that device)."""
    dev = cuda.resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    return Model(cfg, gen, dev)


# ------------------------------------------------------------------ helpers
def _embed_sharded(embed, tokens) -> torch.Tensor:
    """``embed[tokens]`` in the compute dtype for DTensors: on each mesh
    dim of more than one rank that shards the table's vocab (V), every
    rank sees every token and looks up those in its vocab shard (zero
    rows elsewhere), the output a partial sum there (one rank holds each
    token's row, so the sum is exact). Its width (D, FSDP) is gathered,
    or, where every token's slice of it holds less than the vocab shard
    gathered whole would (a decode step), left on its shards, as XLA
    looks rows up there: the tokens are gathered on those dims too, each
    rank looks up its slice of every token's width, and an all-to-all
    sends the rows back to the batch's layout (``shard_to_rows``). The
    table's gradient on each rank is that of its shard; where the table
    is whole beside batch-sharded tokens, it covers that rank's rows
    alone and is summed over the batch's axes (``summed_map``)."""
    mesh = embed.device_mesh
    shards = [(i, p) for i, p in enumerate(embed.placements)
              if isinstance(p, Shard) and mesh.size(i) > 1]
    n_v = embed.shape[0] // math.prod(
        mesh.size(i) for i, p in shards if p == Shard(0))
    n_d = math.prod(mesh.size(i) for i, p in shards if p == Shard(1))
    keep = dict(shards) if tokens.numel() < n_v * n_d else {
        i: p for i, p in shards if p == Shard(0)}
    table = tuple(keep.get(i, Replicate()) if mesh.size(i) > 1 else p
                  for i, p in enumerate(embed.placements))
    tok = tuple(Replicate() if i in keep else s for i, s in enumerate(
        site_placements(tokens, "dp", None)))
    out = tuple(Partial() if keep.get(i) == Shard(0) else Shard(tokens.ndim)
                if keep.get(i) == Shard(1) else s for i, s in enumerate(tok))
    coord = 0
    for i, p in shards:
        if p == Shard(0):
            coord = coord * mesh.size(i) + mesh.get_coordinate()[i]

    def local(tbl, ids):
        ids = ids - coord * n_v
        inside = (ids >= 0) & (ids < n_v)
        rows = tbl[ids.clamp(0, n_v - 1)].to(COMPUTE_DTYPE)
        return torch.where(inside[..., None], rows, 0)

    x = summed_map(local, out_placements=list(out),
                   in_placements=(list(table), list(tok)))(
        embed.redistribute(mesh, table), tokens.redistribute(mesh, tok))
    return shard_to_rows(x, x.ndim - 1)


def _embed(cfg: ArchConfig, params: Model, tokens) -> torch.Tensor:
    if isinstance(params.embed, DTensor):
        x = _embed_sharded(params.embed, tokens)
    else:
        x = params.embed[tokens].to(COMPUTE_DTYPE)  # the rows, then the cast
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    # the vocab-sharded gather can leave its output unsharded; pin it
    return annotate(x, "dp", None, None)


def _unembed(cfg: ArchConfig, params: Model, x) -> torch.Tensor:
    w = (pin_grad(params.embed).T if cfg.tie_embeddings
         else params.unembed).to(x.dtype)
    return softcap(product(x, w).float(), cfg.logits_softcap)


def _is_global_flags(cfg: ArchConfig):
    """Per-layer global flags (gemma3: every ``global_every``-th), or
    None."""
    if cfg.global_every:
        return [(i + 1) % cfg.global_every == 0 for i in range(cfg.n_layers)]
    return None


def _windows(cfg: ArchConfig) -> list:
    """Each dense layer's attention window: none on a global layer."""
    flags = _is_global_flags(cfg) or [False] * cfg.n_layers
    return [None if g else cfg.window for g in flags]


def _positions(cfg: ArchConfig, batch: dict, tokens) -> torch.Tensor:
    """(B, S), or (B, S, 3) under M-RoPE: the batch's own, else 0..S-1
    (in each of the three components)."""
    if cfg.m_rope and "positions" in batch:
        return batch["positions"]
    b, s = tokens.shape
    pos = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    return rows_like(pos[..., None].expand(b, s, 3) if cfg.m_rope else pos,
                     tokens)


def _encoder_forward(cfg: ArchConfig, params: Model,
                     audio_embeds) -> torch.Tensor:
    """The audio encoder: its blocks unmasked over the frames, then
    ``enc_norm``."""
    x = audio_embeds.to(COMPUTE_DTYPE)
    b, t, _ = x.shape
    pos = rows_like(torch.arange(t, device=x.device)[None, :].expand(b, t),
                    x)
    for blk in params.encoder:
        x = blk(x, pos, causal=False, window=cfg.window)
    return params.enc_norm(x)


def _inputs(cfg: ArchConfig, params: Model, batch: dict) -> tuple:
    """(x, positions, enc_out) of a batch: the embedded tokens (vlm: the
    first ``n_patches`` replaced by the batch's patch embeddings), their
    positions, and the audio encoder's output (else None)."""
    tokens = batch["tokens"]
    x = _embed(cfg, params, tokens)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        patches = batch["patch_embeds"]
        x = torch.cat([patches.to(x.dtype), x[:, patches.shape[1]:]], dim=1)
    enc_out = (_encoder_forward(cfg, params, batch["audio_embeds"])
               if cfg.family == "audio" else None)
    return x, _positions(cfg, batch, tokens), enc_out


# ------------------------------------------------------------------ forward
# the products whose outputs remat "dots" keeps
_PRODUCTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


class _Both:
    """Two context managers entered and left as one."""

    def __init__(self, first, second):
        self.cms = (first, second)
        self.stack = contextlib.ExitStack()

    def __enter__(self):
        for cm in self.cms:
            self.stack.enter_context(cm)
        return self

    def __exit__(self, *exc):
        return self.stack.__exit__(*exc)


def _remat_contexts(remat: str) -> tuple:
    """(forward, recompute) contexts of a rematerialised layer: "dots"
    keeps the products' outputs; either recomputes under the annotation
    mesh the forward ran under."""
    fwd, rec = (create_selective_checkpoint_contexts(_PRODUCTS)
                if remat == "dots" else
                (contextlib.nullcontext(), contextlib.nullcontext()))
    return fwd, _Both(rec, reinstall())


def _maybe_remat(fn, remat: str):
    """``fn`` as the reference's ``_maybe_remat`` wraps a layer body."""
    if remat == "none":
        return fn
    if remat not in ("full", "dots"):
        raise ValueError(f"remat must be none, dots or full, not {remat!r}")
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             context_fn=functools.partial(_remat_contexts,
                                                          remat))


def _layers(cfg: ArchConfig, params: Model, x, positions, collect: bool,
            remat: str = "none", enc_out=None):
    """Run the stack (audio: the decoder's, attending to ``enc_out``);
    with ``collect`` also return the caches' parts in layer order: k/v of
    each attention site, (conv, ssm) of each Mamba layer. ``remat``
    applies to attention-stack and Mamba layers, not to the hybrid's
    shared block."""
    kvs, mcs = [], []

    def mamba(blk, x):
        if not collect:
            return _maybe_remat(blk, remat)(x)
        x, mc = blk.prefill(x)
        mcs.append(mc)
        return x

    def attend(blk, x, window, remat=remat):
        if not collect:
            return _maybe_remat(functools.partial(
                blk, positions=positions, window=window, enc_out=enc_out),
                remat)(x)
        x, kv = blk.prefill(x, positions, window=window, enc_out=enc_out)
        kvs.append(kv)
        return x

    if cfg.family in ATTENTION_STACKS:
        for blk, window in zip(params.layers, _windows(cfg)):
            x = attend(blk, x, window)
    elif cfg.family == "ssm":
        for blk in params.layers:
            x = mamba(blk, x)
    else:
        for group in params.mamba_groups:
            for blk in group:
                x = mamba(blk, x)
            x = attend(params.shared, x, cfg.window, remat="none")
        for blk in params.mamba_tail:
            x = mamba(blk, x)
    return x, kvs, mcs


def forward(cfg: ArchConfig, params: Model, batch: dict, *,
            remat: str = "none", pre_logits: bool = False) -> torch.Tensor:
    """Teacher-forced logits (B, S, V), float32. ``remat``: none | dots |
    full, per layer body. ``pre_logits``: return the final-norm hidden
    states instead of logits (the training loss computes chunked CE
    itself)."""
    x, positions, enc_out = _inputs(cfg, params, batch)
    x, _, _ = _layers(cfg, params, x, positions, False, remat, enc_out)
    x = params.final_norm(annotate(x, "dp", None, None))
    return x if pre_logits else _unembed(cfg, params, x)


# ====================================================================== serve
def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               device=None) -> dict:
    """Empty serving cache, in the reference's stacked layout: attention
    k/v (sites, B, max_len, Hkv, Dh) bf16 (audio: also the static
    cross-attention xk/xv (L, B, n_audio_frames, Hkv, Dh)); Mamba conv
    (layers, B, K-1, C) bf16 and ssm (layers, B, H, N, P) fp32 (hybrid:
    groups (n_groups, every, ...), tail, shared). ``device="meta"``
    gives the shapes alone."""
    dev = "meta" if device == "meta" else cuda.resolve_device(device)
    hkv, dh, n_layers = cfg.n_kv_heads, cfg.d_head, cfg.n_layers

    def kv(n):
        return {x: torch.zeros((n, batch, max_len, hkv, dh),
                               dtype=CACHE_DTYPE, device=dev)
                for x in ("k", "v")}

    def mamba(*lead):
        mc = init_mamba_cache(cfg, batch, dev)
        return {x: t.expand(*lead, *t.shape).clone() for x, t in mc.items()}

    if cfg.family in ("dense", "moe", "vlm"):
        return kv(n_layers)
    if cfg.family == "audio":
        out = kv(n_layers)
        out["xk"] = torch.zeros((n_layers, batch, cfg.n_audio_frames, hkv,
                                 dh), dtype=CACHE_DTYPE, device=dev)
        out["xv"] = torch.zeros_like(out["xk"])
        return out
    if cfg.family == "ssm":
        return mamba(n_layers)
    if cfg.family == "hybrid":
        every = cfg.shared_attn_every
        g, tail = divmod(n_layers, every)
        out = {"groups": mamba(g, every), "shared": kv(g)}
        if tail:
            out["tail"] = mamba(tail)
        return out
    raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


def _mamba_caches(cache: dict) -> list:
    """Views of each Mamba layer's (conv, ssm) in layer order."""
    if "groups" not in cache:
        return list(zip(cache["conv"], cache["ssm"])) if "conv" in cache \
            else []
    groups = cache["groups"]
    out = [(groups["conv"][g, j], groups["ssm"][g, j])
           for g in range(groups["conv"].shape[0])
           for j in range(groups["conv"].shape[1])]
    if "tail" in cache:
        out += list(zip(cache["tail"]["conv"], cache["tail"]["ssm"]))
    return out


def _kv_caches(cache: dict) -> list:
    """Views of each attention site's (k, v) in site order."""
    kv = cache.get("shared", cache)
    return list(zip(kv["k"], kv["v"])) if "k" in kv else []


def prefill(cfg: ArchConfig, params: Model, batch: dict, max_len: int):
    """Run the full-sequence path; return (last_logits (B, V), cache,
    cache_len)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"a prompt of {s} tokens does not fit a cache of "
                         f"{max_len}")
    x, positions, enc_out = _inputs(cfg, params, batch)
    x, kvs, mcs = _layers(cfg, params, x, positions, True, enc_out=enc_out)
    if isinstance(tokens, DTensor):  # each rank allocates its shard
        mesh = tokens.device_mesh
        cache = init_cache(cfg, b, max_len, device="meta")
        cache = sharded_zeros(cache, mesh, cache_shardings(
            mesh, cache, b, current_layout()), tokens.device)
    else:
        cache = init_cache(cfg, b, max_len, device=tokens.device)
    if enc_out is not None:
        # the static cross-attention caches: each layer's k, v of the
        # encoder's output (as many frames as it has)
        xkv = [blk.xattn.project_kv(enc_out) for blk in params.layers]
        for i, name in enumerate(("xk", "xv")):
            cache[name] = torch.stack([t[i] for t in xkv]).to(CACHE_DTYPE)
    for (kc, vc), (k, v) in zip(_kv_caches(cache), kvs):
        kc[:, :s] = k
        vc[:, :s] = v
    for (conv, ssm), (c, h) in zip(_mamba_caches(cache), mcs):
        conv.copy_(c)
        ssm.copy_(h)
    x = params.final_norm(x[:, -1:])
    return _unembed(cfg, params, x)[:, 0], cache, s


def decode_step(cfg: ArchConfig, params: Model, cache: dict, tokens,
                cache_len):
    """One token for the whole batch. tokens: (B, 1) integer.

    Returns (logits (B, V), cache), the cache updated in place.
    ``cache_len`` is the number of valid positions already in the cache
    (an int, or a (B,) tensor; one on the tokens' device costs no copy
    from the host, which would wait for the card)."""
    x = _embed(cfg, params, tokens)
    idx = torch.as_tensor(cache_len, device=tokens.device).broadcast_to(
        tokens.shape[:1])
    kvs, mcs = iter(_kv_caches(cache)), iter(_mamba_caches(cache))

    def mamba(blk, x):
        conv, ssm = next(mcs)
        x, new_conv, new_ssm = blk.decode(x, conv, ssm)
        conv.copy_(new_conv)
        ssm.copy_(new_ssm)
        return x

    if cfg.family in ATTENTION_STACKS:
        cross = (zip(cache["xk"], cache["xv"]) if cfg.family == "audio"
                 else itertools.repeat(None))
        for blk, window in zip(params.layers, _windows(cfg)):
            x = blk.decode(x, *next(kvs), idx, window=window,
                           cross=next(cross))
    elif cfg.family == "ssm":
        for blk in params.layers:
            x = mamba(blk, x)
    else:
        for group in params.mamba_groups:
            for blk in group:
                x = mamba(blk, x)
            # the reference passes no window here (zamba2 has none)
            x = params.shared.decode(x, *next(kvs), idx)
        for blk in params.mamba_tail:
            x = mamba(blk, x)
    x = params.final_norm(x)
    return _unembed(cfg, params, x)[:, 0], cache

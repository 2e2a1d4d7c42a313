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
"""
from __future__ import annotations

import functools
import itertools

import torch
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import cuda
from ..configs.base import ArchConfig
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

    def _project_q(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        return (x @ self.wq.to(x.dtype)).reshape(b, s, self.cfg.n_heads,
                                                  self.cfg.d_head)

    def project_kv(self, src: torch.Tensor) -> tuple:
        """k and v of ``src`` (B, Skv, D), each (B, Skv, Hkv, Dh), without
        RoPE: the audio cross-attention's static cache."""
        cfg = self.cfg
        b, skv, _ = src.shape
        dt = src.dtype
        return tuple((src @ w.to(dt)).reshape(b, skv, cfg.n_kv_heads,
                                              cfg.d_head)
                     for w in (self.wk, self.wv))

    def forward(self, x, positions, *, causal=True, window=None, rope=True,
                kv_src=None) -> tuple:
        """Full-sequence attention. x: (B,S,D); positions: (B,S[,3]); k
        and v from ``kv_src`` (B,Skv,D) where given (cross-attention,
        which takes no RoPE). Returns (out, (k, v)), k after RoPE."""
        if rope and kv_src is not None:
            raise ValueError("cross-attention (kv_src) takes no RoPE")
        q = self._project_q(x)
        k, v = self.project_kv(x if kv_src is None else kv_src)
        if rope:
            ang = rope_angles(self.cfg, positions)
            q = apply_rope(q, ang)
            k = apply_rope(k, ang)
        out = blockwise_attention(q, k, v, causal=causal, window=window)
        b, s, _, _ = q.shape
        return out.reshape(b, s, -1) @ self.wo.to(x.dtype), (k, v)

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
            pos = idx[:, None]
            if cfg.m_rope:
                pos = pos[..., None].expand(b, 1, 3)
            ang = rope_angles(cfg, pos)
            q = apply_rope(q, ang)
            if not cross:
                k = apply_rope(k, ang)
        if cross:
            total_len = cache_k.shape[1]  # the whole encoder output
        else:
            rows = torch.arange(b, device=x.device)
            cache_k[rows, idx] = k[:, 0].to(cache_k.dtype)
            cache_v[rows, idx] = v[:, 0].to(cache_v.dtype)
            total_len = idx + 1
        out = decode_attention(q, cache_k.to(q.dtype), cache_v.to(q.dtype),
                               total_len, window=window)
        return out.reshape(b, 1, -1) @ self.wo.to(x.dtype)


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
        return x + (self.mlp(z) if self.moe is None else self.moe(z))

    def _body(self, x, positions, window, causal, enc_out) -> tuple:
        h, kv = self.attn(self.norm1(x), positions, causal=causal,
                          window=window)
        x = x + h
        if self.xattn is not None:
            h, _ = self.xattn(self.norm_x(x), positions, causal=False,
                              rope=False, kv_src=enc_out)
            x = x + h
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
        x = x + self.attn.decode(self.norm1(x), cache_k, cache_v, idx,
                                 window=window)
        if self.xattn is not None:
            x = x + self.xattn.decode(self.norm_x(x), *cross, idx,
                                      rope=False, cross=True)
        return self._ffn(x)


class MambaBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, gen=None, device=None):
        super().__init__()
        self.norm = Norm(cfg, cfg.d_model, device)
        self.mamba = Mamba(cfg, gen, device)

    def prefill(self, x) -> tuple:
        """(x, (conv_state, ssm_state))."""
        h, cache = self.mamba(self.norm(x), return_cache=True)
        return x + h, cache

    def forward(self, x):
        return x + self.mamba(self.norm(x))[0]

    def decode(self, x, conv, ssm) -> tuple:
        h, conv, ssm = self.mamba.decode(conv, ssm, self.norm(x))
        return x + h, conv, ssm


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
def _embed(cfg: ArchConfig, params: Model, tokens) -> torch.Tensor:
    x = params.embed[tokens].to(COMPUTE_DTYPE)  # the rows, then the cast
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _unembed(cfg: ArchConfig, params: Model, x) -> torch.Tensor:
    w = (params.embed.T if cfg.tie_embeddings
         else params.unembed).to(x.dtype)
    return softcap((x @ w).float(), cfg.logits_softcap)


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
    return pos[..., None].expand(b, s, 3) if cfg.m_rope else pos


def _encoder_forward(cfg: ArchConfig, params: Model,
                     audio_embeds) -> torch.Tensor:
    """The audio encoder: its blocks unmasked over the frames, then
    ``enc_norm``."""
    x = audio_embeds.to(COMPUTE_DTYPE)
    b, t, _ = x.shape
    pos = torch.arange(t, device=x.device)[None, :].expand(b, t)
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


def _maybe_remat(fn, remat: str):
    """``fn`` as the reference's ``_maybe_remat`` wraps a layer body."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _PRODUCTS))
    raise ValueError(f"remat must be none, dots or full, not {remat!r}")


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
    x = params.final_norm(x)
    return x if pre_logits else _unembed(cfg, params, x)


# ====================================================================== serve
def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               device=None) -> dict:
    """Empty serving cache, in the reference's stacked layout: attention
    k/v (sites, B, max_len, Hkv, Dh) bf16 (audio: also the static
    cross-attention xk/xv (L, B, n_audio_frames, Hkv, Dh)); Mamba conv
    (layers, B, K-1, C) bf16 and ssm (layers, B, H, N, P) fp32 (hybrid:
    groups (n_groups, every, ...), tail, shared)."""
    dev = cuda.resolve_device(device)
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

"""The port's own ``hybrid_moe`` family: IBM Granite 4.0-H's stack
(``configs/hybrid_moe.py``), each layer a Mamba-2 or a NoPE attention
mixer followed by routed experts and a shared expert.

Port only: the reference package has no such family and no file this
one answers. ``transformer.py``'s entry points (``init_params``,
``forward``, ``init_cache``, ``prefill``, ``decode_step``) hand the
family to the functions here, so ``ServingEngine`` serves it as every
other family. With x the residual stream, ``m`` a layer's mixer and r the
residual multiplier (HF ``granitemoehybrid``):

  x <- embedding_multiplier · embed(ids)
  h <- x + r · m(norm1(x))
  x <- h + r · (MoE(norm2(h)) + Shared(norm2(h)))
  logits = final_norm(x) · embedᵀ / logits_scaling

``m`` is ``mamba2.Mamba`` (in_proj, causal conv over xBC, the SSD
kernels, gated RMSNorm, out_proj) or ``NoPEAttention`` (GQA without
rotary positions, scores scaled by ``attention_multiplier``, the
flash-attention kernel in prefill). Norms are the port's rmsnorm at the
config's ``norm_eps``.

Weights are drawn as the port draws every family's (``layers.dense_init``
and ``embed_init``), but for the tied embedding: its table is drawn at
0.02 / ``embedding_multiplier``, so that the embedded tokens start the
stream at the others' 0.02. Drawn at 0.02, the multiplier makes each
position's own embedding outweigh everything the layers add in its
logits (12·|E_t|², about 20, against about 1), and greedy decoding
repeats the last prompt token whatever the layers compute: on the card
every fault of the benchmark's check, and the reference computed in
float8, then served the same tokens as the program (PERF.md §6).

``HeldMoE`` is one card's share of an expert-parallel, dropless MoE: the
router scores all ``n_router_experts`` and keeps the top k,
renormalised (a softmax over the top k logits, as HF's gating computes
it); the card holds ``n_experts`` experts from ``first_expert`` on and
adds their part, p̂_e · W2_e(silu(Wg_e z) ⊙ Wi_e z), for exactly the
tokens routed to them. No capacity, nothing dropped; nothing stands in
for the absent experts or for an exchange. In prefill the routed rows
are gathered and grouped by expert (one host sync a layer, for their
count) and each held expert multiplies its own rows
(``torch._grouped_mm``); in decode
(a few tokens) every held expert's weights are read once for all the
step's tokens and each token's part weighted by its routing (0 where it
did not route there). The combine sums in float32. On the card a decode
step is one replay of a CUDA graph, captured at the batch's first step
(``_DecodeGraph``).

Tracing: while a ``torch.profiler`` records, host spans on the
profiler's clock (``_RecordFunctionFast``, not ``record_function``,
whose device-side mirror a reader of the trace would take for a kernel):
``lm.prefill``, one ``lm.decode`` a step, and inside them ``lm.mamba`` or
``lm.attn`` around each layer's norm, mixer and residual add, and
``lm.moe`` around its norm, router, dispatch, held experts, combine,
shared expert and residual add; and the module's counters ``calls``
(prefills), ``decode_steps``, ``tokens_routed`` (tokens through a MoE
layer, a layer each), the held-expert rows and the shapes of the SSD
scans launched (``counters()``). A replayed decode step opens only
``lm.decode`` and adds only to ``decode_steps``. Untraced the family
launches, allocates and synchronises nothing for them.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from ..configs.hybrid_moe import HybridMoEConfig
from ..distribution.annotate import annotate
from .layers import Norm, activation, dense_init, param
from .mamba2 import Mamba, init_mamba_cache
from .mlp import MLP, top_k
from . import transformer as tf
from .transformer import Attention, Model, _embed, _unembed

# counted only while a profiler records: prefills, decode steps, tokens
# through a MoE layer (a layer each), and the held experts' rows (prefill's
# on the host; decode's on the device until ``counters()`` reads them)
calls = 0
decode_steps = 0
tokens_routed = 0
held_rows = 0
_held_on_device: list = []
# the SSD scans of traced prefills: (bh, seq, p, n, chunk) each
ssd_scans: list = []

_NO_SPAN = contextlib.nullcontext()


def tracing() -> bool:
    return torch.autograd.profiler._is_profiler_enabled


def span(name: str):
    """A host range on the profiler's clock while one records, else a
    shared no-op."""
    if tracing():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


def counters() -> dict:
    """The counters, the held rows of traced decode steps read from the
    device (one sync; call it after the traced work)."""
    global held_rows
    if _held_on_device:
        held_rows += int(torch.stack(_held_on_device).sum())
        _held_on_device.clear()
    return {"calls": calls, "decode_steps": decode_steps,
            "tokens_routed": tokens_routed, "held_rows": held_rows,
            "ssd_scans": list(ssd_scans)}


class NoPEAttention(Attention):
    """GQA self-attention without rotary positions whose scores are
    scaled by ``attention_multiplier`` in place of d^-1/2: q is scaled
    by ``attention_multiplier`` · d^1/2 after its projection, and the
    kernel (prefill) or the plain decode applies d^-1/2."""

    def _project_q(self, x, uneven=False):
        cfg = self.cfg
        return super()._project_q(x, uneven) * (
            cfg.attention_multiplier * cfg.d_head ** 0.5)


class HeldMoE(nn.Module):
    """The router over all ``n_router_experts`` and the held experts'
    weights: ``router`` (d, R), ``wi`` / ``wg`` (E, d, ff), ``wo`` (E, ff,
    d), E = ``n_experts``, local expert j being id ``first_expert`` + j."""

    def __init__(self, cfg: HybridMoEConfig, gen=None, device=None):
        super().__init__()
        self.cfg = cfg
        d, e, ff = cfg.d_model, cfg.n_experts, cfg.d_ff_expert

        def normal(*shape, scale):
            return param(torch.randn(shape, generator=gen, device=device)
                         * scale)

        self.router = param(dense_init(gen, d, cfg.n_router_experts,
                                       scale=0.02, device=device))
        self.wi = normal(e, d, ff, scale=d ** -0.5)
        self.wo = normal(e, ff, d, scale=ff ** -0.5)
        self.wg = normal(e, d, ff, scale=d ** -0.5)

    def route(self, z: torch.Tensor) -> tuple:
        """z (T, d) -> (top_p (T, K) float32 renormalised, local (T, K)
        the choices' held index, held (T, K) whether this card holds
        it)."""
        cfg = self.cfg
        logits = (z @ self.router.to(z.dtype)).float()
        top_p, top_e = top_k(torch.softmax(logits, dim=-1), cfg.top_k)
        local = top_e - cfg.first_expert
        return top_p, local, (local >= 0) & (local < cfg.n_experts)

    def forward(self, z: torch.Tensor, per_token: bool = False
                ) -> torch.Tensor:
        """z (B, S, d) -> the held experts' part (B, S, d). ``per_token``:
        decode's form, every held expert over all of z's tokens."""
        b, s, d = z.shape
        flat = z.reshape(b * s, d)
        top_p, local, held = self.route(flat)
        y = (self._per_token if per_token else self._grouped)(
            flat, top_p, local, held)
        return y.reshape(b, s, d)

    def _weights(self, dt) -> tuple:
        return self.wi.to(dt), self.wg.to(dt), self.wo.to(dt)

    def _grouped(self, flat, top_p, local, held) -> torch.Tensor:
        """Each held expert over exactly its routed rows, grouped by
        expert, by ``torch._grouped_mm`` (faster on the card than a loop
        over the experts: PERF.md); one host sync, for the rows' count."""
        global tokens_routed, held_rows
        cfg = self.cfg
        t, k = local.shape
        d, e, dt = flat.shape[1], cfg.n_experts, flat.dtype
        key = torch.where(held, local, e).reshape(-1)   # the rest last
        order = torch.argsort(key, stable=True)
        sizes = torch.bincount(key, minlength=e + 1)[:e]
        n = int(sizes.sum())
        if tracing():
            tokens_routed += t
            held_rows += n
        y = torch.zeros((t, d), dtype=torch.float32, device=flat.device)
        if not n:
            return y.to(dt)
        pick = order[:n]
        tok = pick // k
        rows = flat[tok]
        ends = torch.cumsum(sizes, 0, dtype=torch.int32)
        wi, wg, wo = self._weights(dt)
        h = activation(cfg, torch._grouped_mm(rows, wg, offs=ends),
                       torch._grouped_mm(rows, wi, offs=ends))
        out = torch._grouped_mm(h, wo, offs=ends)
        y.index_add_(0, tok, out.float() * top_p.reshape(-1)[pick, None])
        return y.to(dt)

    def _per_token(self, flat, top_p, local, held) -> torch.Tensor:
        """Every held expert over all tokens, each weight read once; a
        token's part weighted by its routing (0 where it did not route
        to the expert)."""
        global tokens_routed
        e = self.cfg.n_experts
        t, d = flat.shape
        w = torch.zeros((t, e), dtype=torch.float32, device=flat.device)
        w.scatter_add_(1, local.clamp(0, e - 1),
                       torch.where(held, top_p, 0.0))
        wi, wg, wo = self._weights(flat.dtype)
        x = flat.expand(e, t, d)
        out = torch.bmm(activation(self.cfg, torch.bmm(x, wg),
                                   torch.bmm(x, wi)), wo)      # (E, T, d)
        if tracing():
            tokens_routed += t
            _held_on_device.append(held.sum())
        return (out.float() * w.T[:, :, None]).sum(0).to(flat.dtype)


def _scan_shape(cfg: HybridMoEConfig, b: int, s: int) -> tuple:
    """(bh, seq, p, n, chunk) of a prefill's SSD scan: the sequence
    padded to the chunk, as ``Mamba`` pads it."""
    chunk = cfg.ssm_chunk
    return (b * cfg.ssm_heads, -(-s // chunk) * chunk,
            cfg.ssm_expand * cfg.d_model // cfg.ssm_heads, cfg.ssm_state,
            chunk)


class Layer(nn.Module):
    """One layer: its mixer (``mamba`` or ``attn``) behind ``norm1``, then
    the held experts (``moe``) and the shared expert (``shared``, a SwiGLU
    ``MLP``) behind ``norm2``, each sum added to the stream times the
    residual multiplier."""

    def __init__(self, cfg: HybridMoEConfig, kind: str, gen=None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.norm1 = Norm(cfg, cfg.d_model, device)
        self.mamba = Mamba(cfg, gen, device) if kind == "mamba" else None
        self.attn = (NoPEAttention(cfg, gen, device) if kind == "attention"
                     else None)
        self.norm2 = Norm(cfg, cfg.d_model, device)
        self.moe = HeldMoE(cfg, gen, device)
        self.shared = MLP(cfg, cfg.d_model, cfg.d_ff_shared, gen, device)
        self.mixer_span = "lm.mamba" if kind == "mamba" else "lm.attn"

    def _ffn(self, x, per_token: bool = False):
        with span("lm.moe"):
            z = self.norm2(x)
            return x + (self.moe(z, per_token) + self.shared(z)) \
                * self.cfg.residual_multiplier

    def prefill(self, x) -> tuple:
        """(x, this layer's cache part): (k, v) in the cache dtype, or
        (conv_state, ssm_state)."""
        with span(self.mixer_span):
            z = self.norm1(x)
            if self.mamba is not None:
                h, part = self.mamba(z, return_cache=True)
                if tracing():
                    ssd_scans.append(_scan_shape(self.cfg, *x.shape[:2]))
            else:
                h, (k, v) = self.attn(z, None, rope=False)
                part = (k.to(tf.CACHE_DTYPE), v.to(tf.CACHE_DTYPE))
            x = x + h * self.cfg.residual_multiplier
        return self._ffn(x), part

    def forward(self, x):
        with span(self.mixer_span):
            z = self.norm1(x)
            h = (self.mamba(z)[0] if self.mamba is not None
                 else self.attn(z, None, rope=False)[0])
            x = x + h * self.cfg.residual_multiplier
        return self._ffn(x)

    def decode(self, x, part, idx):
        """One step; ``part``: this layer's cache views, (k, v) or (conv,
        ssm), written in place."""
        with span(self.mixer_span):
            z = self.norm1(x)
            if self.mamba is not None:
                conv, ssm = part
                h, new_conv, new_ssm = self.mamba.decode(conv, ssm, z)
                conv.copy_(new_conv)
                ssm.copy_(new_ssm)
            else:
                h = self.attn.decode(z, *part, idx, rope=False)
            x = x + h * self.cfg.residual_multiplier
        return self._ffn(x, per_token=True)


def layers(cfg: HybridMoEConfig, gen=None, device=None) -> nn.ModuleList:
    """The stack, one ``Layer`` a ``layer_types`` entry, drawn in order."""
    return nn.ModuleList(Layer(cfg, kind, gen, device)
                         for kind in cfg.layer_types)


def _embedded(cfg, params: Model, tokens) -> torch.Tensor:
    return _embed(cfg, params, tokens) * cfg.embedding_multiplier


def _logits(cfg, params: Model, x) -> torch.Tensor:
    return _unembed(cfg, params, params.final_norm(x)) / cfg.logits_scaling


def forward(cfg, params: Model, batch: dict, remat_fn,
            pre_logits: bool = False) -> torch.Tensor:
    """Teacher-forced logits (B, S, V) float32, each layer through
    ``remat_fn(layer)``."""
    x = _embedded(cfg, params, batch["tokens"])
    for blk in params.layers:
        x = remat_fn(blk)(x)
    x = annotate(x, "dp", None, None)
    if pre_logits:
        return params.final_norm(x)
    return _logits(cfg, params, x)


def init_cache(cfg: HybridMoEConfig, batch: int, max_len: int,
               dev) -> dict:
    """k/v (attention layers, B, max_len, Hkv, Dh) bf16 and Mamba conv
    (Mamba layers, B, K-1, C) bf16 and ssm (Mamba layers, B, H, N, P)
    fp32, each in layer order."""
    n_attn = cfg.layer_types.count("attention")
    n_mamba = cfg.n_layers - n_attn
    out = {x: torch.zeros((n_attn, batch, max_len, cfg.n_kv_heads,
                           cfg.d_head), dtype=tf.CACHE_DTYPE, device=dev)
           for x in ("k", "v")}
    mc = init_mamba_cache(cfg, batch, dev)
    out.update({x: t.expand(n_mamba, *t.shape).clone()
                for x, t in mc.items()})
    return out


def _parts(params: Model, cache: dict) -> list:
    """Each layer's cache views in layer order."""
    kv = iter(zip(cache["k"], cache["v"]))
    mc = iter(zip(cache["conv"], cache["ssm"]))
    return [next(mc) if blk.mamba is not None else next(kv)
            for blk in params.layers]


def prefill(cfg: HybridMoEConfig, params: Model, batch: dict,
            max_len: int) -> tuple:
    """(last_logits (B, V), cache, cache_len), as ``transformer.prefill``."""
    global calls
    tokens = batch["tokens"]
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"a prompt of {s} tokens does not fit a cache of "
                         f"{max_len}")
    with span("lm.prefill"):
        if tracing():
            calls += 1
        x = _embedded(cfg, params, tokens)
        cache = init_cache(cfg, b, max_len, tokens.device)
        for blk, part in zip(params.layers, _parts(params, cache)):
            x, new = blk.prefill(x)
            if blk.mamba is not None:
                for dst, src in zip(part, new):
                    dst.copy_(src)
            else:
                for dst, src in zip(part, new):
                    dst[:, :s] = src
        return _logits(cfg, params, x[:, -1:])[:, 0], cache, s


def _step(cfg: HybridMoEConfig, params: Model, cache: dict, tokens,
          idx) -> torch.Tensor:
    """One decode step's logits (B, V); the cache written in place."""
    x = _embedded(cfg, params, tokens)
    for blk, part in zip(params.layers, _parts(params, cache)):
        x = blk.decode(x, part, idx)
    return _logits(cfg, params, x)[:, 0]


class _DecodeGraph:
    """A batch's decode step captured as one CUDA graph, with the cache it
    writes (``cache``) and its inputs and logits at fixed addresses.

    A step of the eager form launches about 4,400 kernels over the 40
    layers, and the host's pace, not the card's, then sets a step's
    time, which swings with it (PERF.md §6); a replay is one launch. The
    graph reads the weights where they were at capture; ``fits`` asks
    for the same weights, the same shapes and dtypes, and the compute
    and cache dtypes of then."""

    def __init__(self, cfg, params: Model, cache: dict, tokens, idx,
                 stream):
        self.key = _graph_key(params, cache, tokens)
        self.weights = _weight_pointers(params)
        self.cache = {k: torch.empty_like(v) for k, v in cache.items()}
        self.tokens, self.idx = tokens.clone(), idx.clone()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            self.logits = _step(cfg, params, self.cache, self.tokens,
                                self.idx)

    def fits(self, params: Model, cache: dict, tokens) -> bool:
        if _graph_key(params, cache, tokens) != self.key:
            return False
        # a new prefill's cache: the weights may have been replaced since
        return cache is self.cache or \
            _weight_pointers(params) == self.weights

    def __call__(self, cache: dict, tokens, idx) -> tuple:
        if cache is not self.cache:     # a new prefill's: taken over
            for name, t in cache.items():
                self.cache[name].copy_(t)
        self.tokens.copy_(tokens)
        self.idx.copy_(idx)
        self.graph.replay()
        return self.logits.clone(), self.cache


def _graph_key(params: Model, cache: dict, tokens) -> tuple:
    return (id(params), tf.COMPUTE_DTYPE, tf.CACHE_DTYPE,
            tokens.shape, tokens.dtype,
            tuple((k, v.shape, v.dtype) for k, v in cache.items()))


def _weight_pointers(params: Model) -> tuple:
    return tuple(p.data_ptr() for p in params.parameters())


def _graphed(cfg, params: Model, cache: dict, tokens, idx) -> tuple:
    """A step through the batch's graph; where none fits, an eager step
    (on a side stream, the capture's warm-up) and then the capture, not
    while a profiler records. The graph lives as long as ``params``."""
    graph = params.__dict__.get("_decode_graph")
    if graph is not None and graph.fits(params, cache, tokens):
        return graph(cache, tokens, idx)
    if tracing():
        return _step(cfg, params, cache, tokens, idx), cache
    params.__dict__.pop("_decode_graph", None)
    stream = torch.cuda.Stream(tokens.device)
    stream.wait_stream(torch.cuda.current_stream(tokens.device))
    with torch.cuda.stream(stream):
        logits = _step(cfg, params, cache, tokens, idx)
    torch.cuda.current_stream(tokens.device).wait_stream(stream)
    logits.record_stream(torch.cuda.current_stream(tokens.device))
    graph = _DecodeGraph(cfg, params, cache, tokens, idx, stream)
    for name, t in cache.items():
        graph.cache[name].copy_(t)
    params.__dict__["_decode_graph"] = graph
    return logits, graph.cache


def decode_step(cfg: HybridMoEConfig, params: Model, cache: dict, tokens,
                cache_len) -> tuple:
    """(logits (B, V), cache), as ``transformer.decode_step``: on the
    card, and without autograd, a replay of the batch's CUDA graph
    (``_DecodeGraph``), which returns the graph's own cache, a new
    prefill's copied into it; elsewhere the cache updated in place."""
    global decode_steps
    with span("lm.decode"):
        if tracing():
            decode_steps += 1
        idx = torch.as_tensor(cache_len, device=tokens.device).broadcast_to(
            tokens.shape[:1])
        if tokens.is_cuda and not torch.is_grad_enabled():
            return _graphed(cfg, params, cache, tokens, idx)
        return _step(cfg, params, cache, tokens, idx), cache


"""The plain reference of ``granite-4.0-h-small-ep8``: IBM Granite 4.0-H
Small (HF ``granitemoehybrid``) at its published widths, holding experts
``first_held_expert`` onwards of each layer's router, teacher-forced in
float32 from the equations, one prompt at a time.

It imports nothing of the program. Every size comes from the
configuration file and the weights' shapes; the weights come keyed by the
port's parameter names, made afresh from the set-up seed. With x the
residual stream, r ``residual_multiplier`` and n1, n2 RMSNorms at
``rms_norm_eps``:

  x <- embedding_multiplier · embed(ids)
  h <- x + r · mixer(n1(x))           (Mamba-2 or NoPE GQA attention)
  x <- h + r · (MoE(n2(h)) + Shared(n2(h)))
  logits = final_norm(x) · embedᵀ / logits_scaling

  * Mamba-2: in_proj to [z, xBC, dt]; a depthwise causal conv of width
    ``mamba_d_conv`` with bias over xBC, then silu; dt = softplus(dt +
    dt_bias), A = -exp(A_log); the SSD recurrence h_t = exp(dt_t A) h_{t-1}
    + dt_t B_t ⊗ x_t, y_t = C_t · h_t + D x_t, computed as the chunked scan
    over ``mamba_chunk_size`` steps (one group: B and C shared by the
    heads); y · silu(z) through an RMSNorm; out_proj.
  * Attention: q, k, v projections, no rotary positions (NoPE), causal
    softmax of q·k · ``attention_multiplier`` (1/128, not d^-1/2) over
    each kv head's group of q heads; o_proj.
  * MoE: a softmax over the router's logits (all its experts), the top
    ``num_experts_per_tok`` renormalised (equal to a softmax over the top
    logits, HF's gating), and for each held expert e, over exactly the
    tokens that chose it, p̂_e · W2_e(silu(Wg_e z) ⊙ Wi_e z). The experts
    this card does not hold add nothing (the deployment's other cards
    add theirs). Shared: silu(z Wg) ⊙ (z Wi) · Wo, counted whole.

Departures from the HF code, none of which changes the function: weights
are laid out (in, out), as the port keeps them (HF's ``Linear`` holds
(out, in)); HF's concatenated [gate; up] ``input_linear`` of the experts
and of the shared MLP are the port's ``wg`` and ``wi``, and its
``output_linear`` the port's ``wo``; every RMSNorm weight is the port's
``1 + scale``; the conv's (C, 1, K) weight is (K, C); the top k come from
``torch.topk`` (equal probabilities could be ordered otherwise than the
port's stable sort; with float32 router logits none were); HF's
``time_step_limit`` (0, inf) clamp of dt is the identity and left out.
Everything is float32 with TF32 off, where HF's bf16 checkpoint rounds
each intermediate.

``judge`` reads the widest gap over the kept calls' served tokens, as
``served.widest_gap`` defines it (``widest_gap`` here is that reading,
restated because a reference imports nothing but ``torch`` and the
standard library; a test holds the two equal): its logits at the
positions that predict each served token. Every product goes through
``_mm``, one place to compute them otherwise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# logit_gap: the widest gap, over the 128 served tokens of the two judged
# calls, by which a served token's reference logit lies below the
# reference's best there (the logits spread about 0.0067). On the card
# the program reads 0.0018 to 0.0030 over 20 seeds, and this reference
# with every product's operands rounded to float8 e4m3, the precision
# below the program's bf16 products, reads 0.0229 (PERF.md §2): the limit
# lies between, 2.7 and 2.9 times from each; tokens_judged: every served
# token of both calls
LIMITS = {"logit_gap": {"at_most": 0.008},
          "tokens_judged": {"at_least": 128}}


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1 + scale)


def _scan(x, dt, a, b, c, chunk):
    """The chunked SSD scan. x (L, H, P), dt (L, H), a (H,), b/c (L, N) ->
    y (L, H, P)."""
    length, heads, p = x.shape
    h = x.new_zeros((heads, b.shape[1], p))
    ys = []
    for s0 in range(0, length, chunk):
        xc, dtc = x[s0:s0 + chunk], dt[s0:s0 + chunk]
        bc, cc = b[s0:s0 + chunk], c[s0:s0 + chunk]
        q = xc.shape[0]
        cum = torch.cumsum(dtc * a, 0)                        # (Q, H)
        lower = torch.ones((q, q), dtype=torch.bool,
                           device=x.device).tril()
        seg = (cum[:, None, :] - cum[None, :, :]).permute(2, 0, 1)
        decay = torch.exp(torch.where(lower, seg, -torch.inf))   # (H, i, j)
        w = _mm(cc, bc.T)[None] * decay * dtc.T[:, None, :]
        y = _mm(w, xc.permute(1, 0, 2))                         # (H, Q, P)
        y = y + torch.exp(cum).T[:, :, None] * _mm(cc[None], h)
        total = cum[-1]
        wx = (torch.exp(total - cum) * dtc).T[:, :, None] \
            * xc.permute(1, 0, 2)                               # (H, Q, P)
        h = torch.exp(total)[:, None, None] * h + _mm(bc.T[None], wx)
        ys.append(y.permute(1, 0, 2))
    return torch.cat(ys)


def _mamba(cfg, w, pre, z):
    d_in = cfg["mamba_expand"] * cfg["hidden_size"]
    heads, p = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    n, k = cfg["mamba_d_state"], cfg["mamba_d_conv"]
    length = z.shape[0]
    proj = _mm(z, w[pre + "in_proj"])
    gate, xbc, dt = proj.split([d_in, d_in + 2 * n, heads], -1)
    conv_w = w[pre + "conv_w"]
    padded = F.pad(xbc, (0, 0, k - 1, 0))
    xbc = F.silu(sum(padded[i:i + length] * conv_w[i] for i in range(k))
                 + w[pre + "conv_b"])
    xs, bm, cm = xbc.split([d_in, n, n], -1)
    dt = F.softplus(dt + w[pre + "dt_bias"])
    a = -torch.exp(w[pre + "A_log"])
    xh = xs.reshape(length, heads, p)
    y = _scan(xh, dt, a, bm, cm, cfg["mamba_chunk_size"])
    y = (y + w[pre + "D"][:, None] * xh).reshape(length, d_in)
    y = _rmsnorm(y * F.silu(gate), w[pre + "gate_norm"], cfg["rms_norm_eps"])
    return _mm(y, w[pre + "out_proj"])


def _attention(cfg, w, pre, z):
    heads, kv_heads = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = cfg["hidden_size"] // heads
    group = heads // kv_heads
    length = z.shape[0]
    q = _mm(z, w[pre + "wq"]).reshape(length, kv_heads, group, dh)
    k = _mm(z, w[pre + "wk"]).reshape(length, kv_heads, dh)
    v = _mm(z, w[pre + "wv"]).reshape(length, kv_heads, dh)
    causal = torch.ones((length, length), dtype=torch.bool,
                        device=z.device).tril()
    out = torch.empty((length, kv_heads, group, dh), device=z.device)
    for g in range(kv_heads):
        scores = _mm(q[:, g].permute(1, 0, 2), k[:, g].T) \
            * cfg["attention_multiplier"]                    # (group, L, L)
        probs = torch.softmax(torch.where(causal, scores, -torch.inf), -1)
        out[:, g] = _mm(probs, v[:, g]).permute(1, 0, 2)
    return _mm(out.reshape(length, heads * dh), w[pre + "wo"])


def _swiglu(z, wg, wi, wo):
    return _mm(F.silu(_mm(z, wg)) * _mm(z, wi), wo)


def _moe(cfg, w, pre, z):
    """The held experts' part: each over exactly the tokens routed to it."""
    probs = torch.softmax(_mm(z, w[pre + "router"]), -1)
    top_p, top_e = torch.topk(probs, cfg["num_experts_per_tok"], -1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    first = cfg["first_held_expert"]
    y = torch.zeros_like(z)
    for j in range(w[pre + "wi"].shape[0]):
        chose = top_e == first + j                          # (L, K)
        tok = chose.any(-1).nonzero()[:, 0]
        if tok.numel():
            weight = (top_p * chose).sum(-1)[tok, None]
            y[tok] += weight * _swiglu(z[tok], w[pre + "wg"][j],
                                       w[pre + "wi"][j], w[pre + "wo"][j])
    return y


def logits(cfg: dict, w: dict, tokens: torch.Tensor,
           first: int) -> torch.Tensor:
    """tokens (1, L) -> float32 logits (1, L - first, V) of positions
    ``first`` onwards."""
    eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    x = w["embed"][tokens[0]] * cfg["embedding_multiplier"]
    for i, kind in enumerate(cfg["layer_types"]):
        pre = f"layers.{i}."
        z = _rmsnorm(x, w[pre + "norm1.scale"], eps)
        h = (_mamba(cfg, w, pre + "mamba.", z) if kind == "mamba"
             else _attention(cfg, w, pre + "attn.", z))
        x = x + r * h
        z = _rmsnorm(x, w[pre + "norm2.scale"], eps)
        x = x + r * (_moe(cfg, w, pre + "moe.", z)
                     + _swiglu(z, w[pre + "shared.wg"], w[pre + "shared.wi"],
                               w[pre + "shared.wo"]))
    x = _rmsnorm(x[first:], w["final_norm.scale"], eps)
    return (_mm(x, w["embed"].T) / cfg["logits_scaling"])[None]


def widest_gap(logits_fn, calls: list) -> tuple:
    """(widest gap, tokens judged), one request at a time: the logits at
    position S - 1 + j of a prompt of S tokens followed by the served
    tokens judge served token j by how far its logit lies below the
    best there."""
    worst, judged = 0.0, 0
    for call in calls:
        for prompt, served in zip(call["prompts"], call["served"]):
            feed = torch.cat([prompt, served[:-1]])[None]
            lf = logits_fn(feed, prompt.shape[0] - 1)[0].float()
            gaps = lf.max(-1).values - lf.gather(
                -1, served.to(lf.device)[:, None])[:, 0]
            worst = max(worst, float(gaps.max()))
            judged += gaps.numel()
    return worst, judged


def judge(config: dict, weights: dict, calls: list, device) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = {name: t.float() for name, t in weights.items()}

    def fn(tokens, first):
        with torch.no_grad():
            return logits(config, w, tokens.to(device), first)

    gap, judged = widest_gap(fn, calls)
    return {"logit_gap": gap, "tokens_judged": judged}

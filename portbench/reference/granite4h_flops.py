"""Model FLOPs of one served call of ``granite-4.0-h-small-ep8``: only
the work the model must do, products only, an FMA being 2.

A call is a prefill of ``batch`` prompts of S tokens that keeps the last
position's logits, then N - 1 decode steps (the last served token's
successor is never asked for), step i (from 1) at position S + i - 1
attending to S + i keys. Per token and layer:

  * Mamba: in_proj, d x (2 d_in + 2 N + H), and out_proj, d_in x d; the
    depthwise conv and the SSD scan are left out (the scan's operations
    are the SSD's own roofline, ``ssd_flops.py``);
  * attention: the q, k, v and o projections; the scores and the
    weighted values, 2 x heads x d_head a (query, key) pair, S(S+1)/2
    causal pairs a prompt at each site in prefill;
  * MoE: the router over all its experts, and the held experts at the
    rows the routing sends them on average, top_k x held / router
    (10 x 9 / 72 = 1.25 a token), three products of d x expert width
    each; the shared expert's three of d x its width;

and the tied unembedding, d x vocab, at each position whose logits are
kept.
"""
from __future__ import annotations


def layer_flops(config: dict) -> dict:
    """FLOPs a token of one layer of each kind, and of the unembedding;
    ``pair`` is an attention site's FLOPs a (query, key) pair."""
    d = config["hidden_size"]
    heads, kv_heads = config["num_attention_heads"], config["num_key_value_heads"]
    dh = d // heads
    d_in = config["mamba_expand"] * d
    n, mh = config["mamba_d_state"], config["mamba_n_heads"]
    router = config["router_experts"]
    rows = config["num_experts_per_tok"] * config["num_local_experts"] / router
    ffn = 2 * (d * router + rows * 3 * d * config["intermediate_size"]
               + 3 * d * config["shared_intermediate_size"])
    return {"mamba": 2 * (d * (2 * d_in + 2 * n + mh) + d_in * d) + ffn,
            "attention": 2 * (2 * d * heads * dh + 2 * d * kv_heads * dh)
            + ffn,
            "pair": 2 * 2 * heads * dh,
            "unembed": 2 * d * config["vocab_size"]}


def call_flops(config: dict, batch: int, prompt_len: int,
               new_tokens: int) -> int:
    f = layer_flops(config)
    kinds = config["layer_types"]
    per_token = sum(f[k] for k in kinds)
    sites = kinds.count("attention")
    s, steps = prompt_len, new_tokens - 1
    prefill = (batch * s * per_token + batch * sites * f["pair"]
               * s * (s + 1) // 2 + batch * f["unembed"])
    decode = sum(batch * (per_token + sites * f["pair"] * (s + i)
                          + f["unembed"]) for i in range(1, steps + 1))
    return int(prefill + decode)

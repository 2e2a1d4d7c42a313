"""granite-4.0-h-small-ep8 — [hybrid_moe] IBM Granite 4.0-H Small (32B-A9B,
2025-10) at its published widths, as one card of an 8-way
expert-parallel deployment holds it: experts 0–8 of each layer's 72.
Source: huggingface.co/ibm-granite/granite-4.0-h-small, config.json
(``intermediate_size`` 768 is one expert's width). Port only; no
reference file."""
from .hybrid_moe import HybridMoEConfig

_ATTENTION_AT = (5, 15, 25, 35)

CONFIG = HybridMoEConfig(
    name="granite-4.0-h-small-ep8", family="hybrid_moe", n_layers=40,
    d_model=4096, n_heads=32, n_kv_heads=8, d_head=128, d_ff=0,
    vocab=100352, norm="rmsnorm", act="swiglu", tie_embeddings=True,
    layer_types=tuple("attention" if i in _ATTENTION_AT else "mamba"
                      for i in range(40)),
    # 9 of the router's 72 held here (8-way expert parallelism), top 10
    n_router_experts=72, n_experts=9, first_expert=0, top_k=10,
    d_ff_expert=768, d_ff_shared=1536,
    ssm_state=128, ssm_heads=128, ssm_d_head=64, ssm_expand=2, conv_width=4,
    ssm_chunk=256,
    embedding_multiplier=12.0, residual_multiplier=0.22,
    attention_multiplier=0.0078125, logits_scaling=16.0, norm_eps=1e-5)

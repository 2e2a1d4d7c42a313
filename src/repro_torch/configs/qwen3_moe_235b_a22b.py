"""qwen3-moe-235b-a22b — [moe] 128 experts top-8 (assigned dims; pool source
hf:Qwen/Qwen3-30B-A3B / Qwen3 family). A copy of
``src/repro/configs/qwen3_moe_235b_a22b.py``."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe", n_layers=94, d_model=4096,
    n_heads=64, n_kv_heads=4, d_head=128, d_ff=0, vocab=151936,
    n_experts=128, top_k=8, d_ff_expert=1536, rope_theta=1e6,
    norm="rmsnorm", act="swiglu", tie_embeddings=False)

"""Config: see class docstring comments inline. A copy of
``src/repro/configs/grok_1_314b.py``."""
from .base import ArchConfig

CONFIG = ArchConfig(
    # [moe] 8 experts top-2 — hf:xai-org/grok-1
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144,
    n_heads=48, n_kv_heads=8, d_head=128, d_ff=0, vocab=131072,
    n_experts=8, top_k=2, d_ff_expert=32768, rope_theta=1e4,
    norm="rmsnorm", act="geglu", tie_embeddings=True, logits_softcap=30.0)

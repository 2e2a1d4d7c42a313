"""Config: see class docstring comments inline. A copy of
``src/repro/configs/zamba2_1_2b.py``."""
from .base import ArchConfig

CONFIG = ArchConfig(
    # [hybrid] Mamba2 + shared attention blocks — arXiv:2411.15242
    name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
    n_heads=32, n_kv_heads=32, d_head=64, d_ff=8192, vocab=32000,
    ssm_state=64, ssm_heads=64, ssm_d_head=64, ssm_expand=2,
    shared_attn_every=6, norm="rmsnorm", act="swiglu", tie_embeddings=True)

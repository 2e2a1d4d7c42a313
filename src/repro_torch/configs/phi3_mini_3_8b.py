"""Config: see class docstring comments inline. A copy of
``src/repro/configs/phi3_mini_3_8b.py``."""
from .base import ArchConfig

CONFIG = ArchConfig(
    # [dense] RoPE SwiGLU GQA — arXiv:2404.14219
    name="phi3-mini-3.8b", family="dense", n_layers=32, d_model=3072,
    n_heads=32, n_kv_heads=32, d_head=96, d_ff=8192, vocab=32064,
    rope_theta=1e4, norm="rmsnorm", act="swiglu", tie_embeddings=False)

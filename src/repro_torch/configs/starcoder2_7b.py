"""Config: see class docstring comments inline. A copy of
``src/repro/configs/starcoder2_7b.py``."""
from .base import ArchConfig

CONFIG = ArchConfig(
    # [dense] GQA + RoPE — arXiv:2402.19173
    name="starcoder2-7b", family="dense", n_layers=32, d_model=4608,
    n_heads=36, n_kv_heads=4, d_head=128, d_ff=18432, vocab=49152,
    rope_theta=1e5, norm="layernorm_np", act="gelu", tie_embeddings=False)

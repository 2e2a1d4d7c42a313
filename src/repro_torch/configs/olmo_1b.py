"""Config: see class docstring comments inline. A copy of
``src/repro/configs/olmo_1b.py``."""
from .base import ArchConfig

CONFIG = ArchConfig(
    # [dense] non-parametric LN — arXiv:2402.00838
    name="olmo-1b", family="dense", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=8192, vocab=50304,
    rope_theta=1e4, norm="layernorm_np", act="swiglu", tie_embeddings=True)

"""Config: see class docstring comments inline. A copy of
``src/repro/configs/qwen2_vl_2b.py``."""
from .base import ArchConfig

CONFIG = ArchConfig(
    # [vlm] M-RoPE, dynamic resolution (patch frontend stubbed) —
    # arXiv:2409.12191
    name="qwen2-vl-2b", family="vlm", n_layers=28, d_model=1536,
    n_heads=12, n_kv_heads=2, d_head=128, d_ff=8960, vocab=151936,
    m_rope=True, rope_theta=1e6, norm="rmsnorm", act="swiglu",
    tie_embeddings=True, n_patches=256)

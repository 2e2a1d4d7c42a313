"""Config: see class docstring comments inline. A copy of
``src/repro/configs/mamba2_130m.py``."""
from .base import ArchConfig

CONFIG = ArchConfig(
    # [ssm] SSD — arXiv:2405.21060
    name="mamba2-130m", family="ssm", n_layers=24, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=0, vocab=50280,
    ssm_state=128, ssm_heads=24, ssm_d_head=64, ssm_expand=2, conv_width=4,
    norm="rmsnorm", act="swiglu", tie_embeddings=True)

"""Config: see class docstring comments inline. A copy of
``src/repro/configs/gemma3_1b.py``."""
from .base import ArchConfig

CONFIG = ArchConfig(
    # [dense] 5:1 local:global, 128k — hf:google/gemma-3-1b-pt
    name="gemma3-1b", family="dense", n_layers=26, d_model=1152,
    n_heads=4, n_kv_heads=1, d_head=256, d_ff=6912, vocab=262144,
    rope_theta=1e6, window=512, global_every=6, norm="rmsnorm", act="geglu",
    tie_embeddings=True, scale_embed=True)

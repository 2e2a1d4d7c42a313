"""Config: see class docstring comments inline. A copy of
``src/repro/configs/whisper_small.py``."""
from .base import ArchConfig

CONFIG = ArchConfig(
    # [audio] enc-dec, conv frontend stubbed — arXiv:2212.04356
    name="whisper-small", family="audio", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab=51865,
    n_encoder_layers=12, n_audio_frames=1500,
    rope_theta=1e4, norm="layernorm_np", act="gelu", tie_embeddings=True)

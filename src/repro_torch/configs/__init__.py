"""Assigned architecture configs (10), the port's own (``PORT_ARCHS``) and
the input-shape registry.

One module per architecture (``configs/<id>.py``, exact dims from public
literature — sources in each file); reduced smoke-test variants come from
``ArchConfig.tiny()``. The shape registry defines the four assignment shapes
and the per-cell support rules.

Port of ``src/repro/configs/__init__.py``, a copy: the same registry,
shapes and support rules, so a config name means the same model in both
packages. ``PORT_ARCHS`` holds configurations the reference does not
have (``hybrid_moe.py``); ``get_config`` resolves both registries, and
``ARCHS`` stays the reference's.
"""
from __future__ import annotations

import dataclasses

from .base import ArchConfig
from .gemma3_1b import CONFIG as GEMMA3_1B
from .granite_4_0_h_small_ep8 import CONFIG as GRANITE4H_SMALL_EP8
from .grok_1_314b import CONFIG as GROK1_314B
from .mamba2_130m import CONFIG as MAMBA2_130M
from .olmo_1b import CONFIG as OLMO_1B
from .phi3_mini_3_8b import CONFIG as PHI3_MINI
from .qwen2_vl_2b import CONFIG as QWEN2_VL_2B
from .qwen3_moe_235b_a22b import CONFIG as QWEN3_MOE
from .starcoder2_7b import CONFIG as STARCODER2_7B
from .whisper_small import CONFIG as WHISPER_SMALL
from .zamba2_1_2b import CONFIG as ZAMBA2_1B

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in (
        MAMBA2_130M, STARCODER2_7B, PHI3_MINI, GEMMA3_1B, OLMO_1B,
        GROK1_314B, QWEN3_MOE, WHISPER_SMALL, QWEN2_VL_2B, ZAMBA2_1B,
    )
}


# the port's own configurations (no counterpart in the reference)
PORT_ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in (GRANITE4H_SMALL_EP8,)
}


def get_config(name: str) -> ArchConfig:
    try:
        return ARCHS[name] if name in ARCHS else PORT_ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(ARCHS) + sorted(PORT_ARCHS)}")


# --------------------------------------------------------------------------
# Input shapes (assignment: 4 per arch, 40 cells)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_supported(arch: ArchConfig, shape: ShapeConfig) -> tuple:
    """(supported, reason). long_500k needs sub-quadratic attention; whisper's
    decoder is bounded by construction (448 tokens) so 500k is out of family.
    """
    if shape.name == "long_500k":
        if arch.family == "audio":
            return False, "whisper decoder is 448-token by construction"
        if not arch.sub_quadratic:
            return False, "pure full-attention arch (skip per assignment)"
    return True, ""

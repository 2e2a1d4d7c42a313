"""Architecture configuration schema.

One frozen dataclass describes every assigned architecture; family-specific
fields are zero/None when unused. ``tiny()`` derives the reduced smoke-test
variant (same family and wiring, small dims) used by the CPU test suite —
the full configs are exercised only through the dry-run (ShapeDtypeStruct,
no allocation).

Port of ``src/repro/configs/base.py``, a copy. In the port the full
configs are also served on the card (``repro_torch.launch.serve --preset
full``), every family of them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                # 0 -> d_model // n_heads

    # attention flavour
    rope_theta: float = 10_000.0
    window: Optional[int] = None   # sliding-window size for local layers
    global_every: int = 0          # gemma3: every k-th layer is global
    m_rope: bool = False           # qwen2-vl multimodal rotary
    logits_softcap: float = 0.0

    # norms / activations
    norm: str = "rmsnorm"          # rmsnorm | layernorm_np (olmo)
    act: str = "swiglu"            # swiglu | gelu | geglu
    tie_embeddings: bool = True
    scale_embed: bool = False      # gemma-style sqrt(d) embedding scale

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_d_head: int = 0
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 128

    # hybrid (zamba2): shared attention block every k mamba layers
    shared_attn_every: int = 0

    # enc-dec (whisper)
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500     # stub frontend sequence length

    # vlm (qwen2-vl)
    n_patches: int = 0             # stub patch-embedding count

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.n_heads and self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError(f"{self.name}: n_heads % n_kv_heads != 0")

    # --------------------------------------------------------------- sizes
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / mostly-local attention)."""
        return self.family in ("ssm", "hybrid") or self.global_every > 0

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + layer stacks)."""
        d, v = self.d_model, self.vocab
        n = v * d  # embeddings (tied head)
        if not self.tie_embeddings:
            n += v * d
        for _ in range(1):
            pass
        per_attn = d * (self.n_heads * self.d_head) * 2 \
            + d * (self.n_kv_heads * self.d_head) * 2
        mlp_mult = 3 if self.act in ("swiglu", "geglu") else 2
        per_mlp = mlp_mult * d * self.d_ff if self.d_ff else 0
        if self.family == "moe":
            per_moe = self.n_experts * mlp_mult * d * self.d_ff_expert + d * self.n_experts
            n += self.n_layers * (per_attn + per_moe)
        elif self.family == "ssm":
            n += self.n_layers * self._mamba_params()
        elif self.family == "hybrid":
            n += self.n_layers * self._mamba_params()
            n += per_attn + per_mlp  # one shared block
        elif self.family == "audio":
            n += (self.n_layers + self.n_encoder_layers) * (per_attn + per_mlp)
            n += self.n_layers * per_attn  # cross-attention
        else:
            n += self.n_layers * (per_attn + per_mlp)
        return int(n)

    def _mamba_params(self) -> int:
        d = self.d_model
        d_in = self.ssm_expand * d
        nh = self.ssm_heads if self.ssm_heads else d_in // max(self.ssm_d_head, 1)
        return (d * (2 * d_in + 2 * self.ssm_state + nh)  # in_proj
                + d_in * d                                 # out_proj
                + self.conv_width * (d_in + 2 * self.ssm_state)
                + 3 * nh)                                  # A, dt_bias, D

    def active_param_count(self) -> int:
        """Active (per-token) parameters — MoE counts only top_k experts."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        mlp_mult = 3 if self.act in ("swiglu", "geglu") else 2
        per_attn = d * (self.n_heads * self.d_head) * 2 \
            + d * (self.n_kv_heads * self.d_head) * 2
        per_act = self.top_k * mlp_mult * d * self.d_ff_expert + d * self.n_experts
        return int(self.vocab * d + self.n_layers * (per_attn + per_act))

    # ---------------------------------------------------------------- tiny
    def tiny(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        replace = dict(
            name=self.name + "-tiny",
            n_layers=min(self.n_layers, 4 if self.family not in ("hybrid",) else 5),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads else 0,
            d_head=16,
            d_ff=128,
            vocab=512,
            window=min(self.window, 32) if self.window else None,
            n_audio_frames=24 if self.family == "audio" else self.n_audio_frames,
            n_patches=8 if self.family == "vlm" else self.n_patches,
        )
        if self.n_experts:
            replace.update(n_experts=4, top_k=min(self.top_k, 2), d_ff_expert=64)
        if self.ssm_state:
            replace.update(ssm_state=16, ssm_heads=4, ssm_d_head=32,
                           ssm_chunk=16)
        if self.n_encoder_layers:
            replace.update(n_encoder_layers=2)
        if self.shared_attn_every:
            replace.update(shared_attn_every=2)
        if self.global_every:
            replace.update(global_every=min(self.global_every, 3))
        return dataclasses.replace(self, **replace)

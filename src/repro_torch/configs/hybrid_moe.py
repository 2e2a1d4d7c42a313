"""The port's own architecture family ``hybrid_moe``: a per-layer list of
mixers (Mamba-2 or NoPE GQA attention), each layer followed by a routed
mixture of experts and a shared expert, with the stream's multipliers of
IBM's Granite 4.0-H (HF ``granitemoehybrid``).

Port only: the reference package has no such family and no file this
one answers; ``ARCHS`` and ``FAMILIES`` stay the reference's, and
``configs.get_config`` resolves these names from ``PORT_ARCHS`` beside
them.

The routed experts are one card's share of an expert-parallel layer: the
router scores all ``n_router_experts`` and keeps ``top_k`` of them; the
card holds ``n_experts`` of them, ids ``first_expert`` onwards, and
computes their part of the layer for exactly the tokens routed to them
(``models/hybrid_moe.py``). With ``first_expert`` 0 and ``n_experts`` ==
``n_router_experts`` the layer is whole.
"""
from __future__ import annotations

import dataclasses

from .base import ArchConfig

MIXERS = ("mamba", "attention")


@dataclasses.dataclass(frozen=True)
class HybridMoEConfig(ArchConfig):
    layer_types: tuple = ()        # a mixer of MIXERS a layer
    n_router_experts: int = 0      # the router's width (published experts)
    first_expert: int = 0          # the first held expert's id
    d_ff_shared: int = 0           # the shared expert's width
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float = 0.0   # the scores' scale (not d^-1/2)
    logits_scaling: float = 1.0         # logits are divided by it
    norm_eps: float = 1e-5

    def __post_init__(self):
        super().__post_init__()
        if len(self.layer_types) != self.n_layers or not set(
                self.layer_types) <= set(MIXERS):
            raise ValueError(f"{self.name}: layer_types must give one of "
                             f"{MIXERS} for each of {self.n_layers} layers")
        if not (0 <= self.first_expert and self.first_expert
                + self.n_experts <= self.n_router_experts):
            raise ValueError(f"{self.name}: held experts {self.first_expert}"
                             f"..{self.first_expert + self.n_experts - 1} "
                             f"outside the router's {self.n_router_experts}")

    def param_count(self) -> int:
        """Parameters this card holds: the held experts, not the router's
        other ones."""
        d, ff = self.d_model, self.d_ff_expert
        per_attn = d * self.n_heads * self.d_head * 2 \
            + d * self.n_kv_heads * self.d_head * 2
        per_ffn = (3 * self.n_experts * d * ff + d * self.n_router_experts
                   + 3 * d * self.d_ff_shared + 2 * d)       # + both norms
        d_in = self.ssm_expand * d
        # + the conv's bias and the gated norm's scale
        per_mamba = self._mamba_params() + 2 * d_in + 2 * self.ssm_state
        mixers = sum(per_mamba if t == "mamba" else per_attn
                     for t in self.layer_types)
        return int(self.vocab * d + d + mixers + self.n_layers * per_ffn)

    def tiny(self) -> "HybridMoEConfig":
        """A CPU-test size: one attention layer among three Mamba ones,
        16 routed experts, top 4, this card holding 2 of them."""
        return dataclasses.replace(
            self, name=self.name + "-tiny", n_layers=4,
            layer_types=("mamba", "attention", "mamba", "mamba"),
            d_model=64, n_heads=4, n_kv_heads=2, d_head=16, vocab=512,
            n_router_experts=16, n_experts=2, first_expert=0, top_k=4,
            d_ff_expert=32, d_ff_shared=48, ssm_state=16, ssm_heads=4,
            ssm_d_head=32, ssm_chunk=16, attention_multiplier=1 / 16)

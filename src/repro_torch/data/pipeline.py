"""Deterministic synthetic data pipeline.

A copy of ``src/repro/data/pipeline.py`` (numpy only, so nothing to
translate; the constructor's unused Philox generator is left out):
batches are bit-identical to the reference's.

Stateless and resumable: the batch for (step, shard) is a pure function of
(seed, step, shard) via counter-based Philox bits — restart from a
checkpointed step reproduces the exact token stream with no iterator state
to save, and elastic re-sharding (different dp_shards) keeps global batches
identical because sharding happens by slicing the *global* batch.

Tokens follow a Zipf-ish marginal with short-range structure so the LM loss
actually decreases (pure uniform noise has no learnable signal beyond
unigram frequency).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


class TokenPipeline:
    def __init__(self, dc: DataConfig, arch: ArchConfig | None = None,
                 dp_shards: int = 1, shard_id: int = 0):
        assert dc.global_batch % dp_shards == 0
        self.dc = dc
        self.arch = arch
        self.dp_shards = dp_shards
        self.shard_id = shard_id
        self.local_batch = dc.global_batch // dp_shards
        # Zipf-ish unigram table (fixed per vocab/seed)
        ranks = np.arange(1, dc.vocab + 1)
        probs = 1.0 / ranks ** 1.1
        self._probs = probs / probs.sum()

    def _bits(self, step: int, n: int) -> np.random.Generator:
        return np.random.Generator(
            np.random.Philox(key=[self.dc.seed, step]))

    def global_batch_at(self, step: int) -> dict:
        """Full global batch for a step (B, S+1) — sharding slices this."""
        dc = self.dc
        g = self._bits(step, dc.global_batch * (dc.seq_len + 1))
        u = g.random((dc.global_batch, dc.seq_len + 1))
        base = np.searchsorted(np.cumsum(self._probs), u).astype(np.int32)
        base = np.minimum(base, dc.vocab - 1)
        # short-range structure: every 4th token repeats an earlier one
        repeat = np.roll(base, 3, axis=1)
        mask = (np.arange(dc.seq_len + 1)[None, :] % 4 == 0)
        tokens = np.where(mask, repeat, base).astype(np.int32)
        out = {"tokens": tokens}
        if self.arch is not None and self.arch.family == "vlm":
            pos = np.broadcast_to(
                np.arange(dc.seq_len + 1, dtype=np.int32)[None, :, None],
                (dc.global_batch, dc.seq_len + 1, 3))
            out["positions"] = np.ascontiguousarray(pos)
            out["patch_embeds"] = g.standard_normal(
                (dc.global_batch, self.arch.n_patches, self.arch.d_model),
                dtype=np.float32) * 0.02
        if self.arch is not None and self.arch.family == "audio":
            out["audio_embeds"] = g.standard_normal(
                (dc.global_batch, self.arch.n_audio_frames,
                 self.arch.d_model), dtype=np.float32) * 0.1
        return out

    def batch_at(self, step: int) -> dict:
        """This shard's slice of the global batch (local_batch, S+1)."""
        full = self.global_batch_at(step)
        lo = self.shard_id * self.local_batch
        hi = lo + self.local_batch
        return {k: v[lo:hi] for k, v in full.items()}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

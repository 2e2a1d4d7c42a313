"""Batched serving engine: prefill + greedy/temperature decode loop.

Port of ``src/repro/inference/engine.py``. ``ServingEngine`` drives a
batch of requests through one ``prefill`` (the flash-attention and SSD
kernels on the card) and a decode step a token. What changed:

  * No ``jax.jit``: PyTorch runs eagerly, so the engine calls
    ``prefill`` and ``decode_step`` directly, under
    ``torch.inference_mode``. The float32 weights are cast to bf16 where
    they are used, as in the reference (bf16 copies made once gained
    nothing measurable on the card's host-bound decode and cost 2.2 GB
    at zamba2-1.2b; PERF.md).
  * Temperature sampling is Gumbel-max, as ``jax.random.categorical``,
    with noise from the ``torch.Generator`` passed to ``generate`` in
    place of the reference's ``key`` (default: one seeded 0, as its
    ``PRNGKey(0)``): deterministic under a seed, but not JAX's draws.
    Greedy decoding matches the reference.
  * ``cache_len`` stays on the device through the decode loop, so a
    step issues no copy from the host that would wait for the card.
  * ``generate`` raises ``ValueError`` when the prompt and the new tokens
    do not fit ``max_len`` (the reference's cache update would clamp and
    overwrite the last slot), and records ``timings``: prefill and decode
    times by CUDA events on the card, by the host clock on the CPU.

As in the reference, prompts are left-aligned and padded with token 0 up
to the longest (despite its comment), so the first token of a shorter
request continues a pad position (ROADMAP Queue 3). The batch carries
the reference's family inputs, made on the device: zero audio embeddings
(B, n_audio_frames, d) for ``audio``; zero patch embeddings (B,
n_patches, d) and M-RoPE positions (B, S, 3) for ``vlm``.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from ..configs.base import ArchConfig
from ..models.transformer import Model, decode_step, prefill


@dataclasses.dataclass
class Request:
    prompt: list            # token ids
    max_new_tokens: int = 16
    temperature: float = 0.0


def make_decode_fn(cfg: ArchConfig):
    """The single-token step."""
    def step(params, cache, tokens, cache_len):
        return decode_step(cfg, params, cache, tokens, cache_len)
    return step


class _Clock:
    """Marks on the device's timeline: CUDA events on the card, the host
    clock (after the work it measures was issued) on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())

    def ms(self, i: int, j: int) -> float:
        if self.cuda:
            self.marks[j].synchronize()
            return self.marks[i].elapsed_time(self.marks[j])
        return (self.marks[j] - self.marks[i]) * 1e3


def family_inputs(cfg: ArchConfig, b: int, plen: int, device) -> dict:
    """The reference's stub inputs of ``cfg``'s family for a batch of
    ``b`` prompts of ``plen`` tokens (``repro/inference/engine.py:51-58``);
    empty for the text-only families."""
    out = {}
    if cfg.family == "audio":
        out["audio_embeds"] = torch.zeros(
            (b, cfg.n_audio_frames, cfg.d_model), device=device)
    if cfg.family == "vlm":
        out["patch_embeds"] = torch.zeros((b, cfg.n_patches, cfg.d_model),
                                          device=device)
        out["positions"] = torch.arange(plen, device=device)[
            None, :, None].expand(b, plen, 3)
    return out


class ServingEngine:
    def __init__(self, cfg: ArchConfig, params: Model, max_len: int = 512):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.device = params.embed.device
        self._decode = make_decode_fn(cfg)
        self.timings: dict = {}

    def generate(self, requests: list,
                 generator: torch.Generator | None = None) -> list:
        """Greedy (or sampled) continuation for a batch of requests. Fills
        ``timings``: ``prefill_ms``, ``decode_ms`` (all decode steps) and
        ``steps``."""
        cfg = self.cfg
        b = len(requests)
        plen = max(len(r.prompt) for r in requests)
        max_new = max(r.max_new_tokens for r in requests)
        if plen + max_new > self.max_len:
            raise ValueError(f"{plen} prompt + {max_new} new tokens do not "
                             f"fit max_len {self.max_len}")
        toks = torch.zeros((b, plen), dtype=torch.long)
        for i, r in enumerate(requests):  # left-aligned, padded with 0
            toks[i, :len(r.prompt)] = torch.as_tensor(r.prompt)
        gen = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(0)
        temperature = requests[0].temperature
        clock = _Clock(self.device)
        outs = []
        with torch.inference_mode():
            toks = toks.to(self.device)
            clock.mark()
            batch = {"tokens": toks,
                     **family_inputs(cfg, b, plen, self.device)}
            logits, cache, cache_len = prefill(cfg, self.params, batch,
                                               self.max_len)
            clock.mark()
            cache_len = torch.full((b,), cache_len, device=self.device)
            for _ in range(max_new):
                if temperature > 0:
                    u = torch.rand(logits.shape, generator=gen,
                                   device=self.device)
                    u = u.clamp_min(torch.finfo(u.dtype).tiny)
                    nxt = torch.argmax(logits / temperature
                                       - torch.log(-torch.log(u)), dim=-1)
                else:
                    nxt = torch.argmax(logits, dim=-1)
                outs.append(nxt)
                logits, cache = self._decode(self.params, cache,
                                             nxt[:, None], cache_len)
                cache_len = cache_len + 1
            clock.mark()
        self.timings = {"prefill_ms": clock.ms(0, 1),
                        "decode_ms": clock.ms(1, 2), "steps": max_new}
        if not outs:
            return [[] for _ in range(b)]
        return torch.stack(outs, dim=1).tolist()

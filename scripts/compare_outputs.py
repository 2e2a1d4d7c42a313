#!/usr/bin/env python3
"""Hold the flash-attention and SSD kernels' outputs, and a zamba2-1.2b
prefill and forward, bit for bit against another tree's, on one card.

    python3 scripts/compare_outputs.py --other build/parent

``--other`` is the root of another checkout (e.g. a ``git archive`` of
the parent commit unpacked under ``build/``). The script computes every
case with the other tree's ``repro_torch`` and with this tree's, each in
a child process that builds its own kernels, and fails unless every
output is ``torch.equal`` to the other's. The cases: each flash-attention
instantiation (d 64, 128 and 256, float32 and bf16, both block shapes)
causal, non-causal and with a window, with GQA; the serving shapes of
``chip_smoke.py`` phase 7; the SSD at chunks 16 to 512 with and without
the final state; a prefill (logits and caches) and a forward of
zamba2-1.2b at full width on 2 x 1024 tokens; whisper-small's encoder
and cross-attention calls (1,500 frames padded to 1,536, a key-length
bound) and a prefill of it at full width. A change that is meant to
leave these outputs alone (a new output beside them) is checked so. A
case the other tree cannot compute (its wrapper lacks an argument it
needs) is listed as new, not compared.
"""
from __future__ import annotations

import argparse
import inspect
import os
import pathlib
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def cases() -> dict:
    """Every output, on the CPU, keyed by case."""
    from repro_torch import cuda
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
    from repro_torch.models import transformer as tf

    cuda.build(["flash_attention", "ssd"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        for d in (64, 128, 256):
            for bq, bkv in ((64, 128), (128, 128), (256, 512)):
                for causal, window in ((True, None), (False, None),
                                       (True, 96)):
                    q = randn(4, 512, d, dtype=dtype)
                    k, v = (randn(2, 512, d, dtype=dtype) for _ in range(2))
                    out[f"attn {dtype} d{d} ({bq},{bkv}) {causal} "
                        f"{window}"] = fa.flash_attention(
                        q, k, v, block_q=bq, block_kv=bkv, causal=causal,
                        window=window).cpu()
    q, k, v = (randn(128, 1024, 64, dtype=torch.bfloat16) for _ in range(3))
    out["attn serving"] = fa.flash_attention(q, k, v).cpu()
    if "kv_len" in inspect.signature(fa.flash_attention).parameters:
        # whisper-small's shapes: 4 x 12 heads, 1,500 frames padded to
        # 1,536, 256 decoder tokens
        k, v = (randn(48, 1536, 64, dtype=torch.bfloat16) for _ in range(2))
        for name, sq in (("encoder", 1536), ("cross", 256)):
            q = randn(48, sq, 64, dtype=torch.bfloat16)
            out[f"attn whisper {name}"] = fa.flash_attention(
                q, k, v, causal=False, kv_len=1500).cpu()
    for chunk in (16, 64, 128, 512):
        args = ssd.live_inputs({"bh": 8, "seq": 1024, "p": 64, "n": 64,
                                "seed": chunk}, "cuda")
        out[f"ssd chunk {chunk}"] = ssd.ssd_scan(*args, chunk=chunk).cpu()
        y, h = ssd.ssd_scan(*args, chunk=chunk, final_state=True)
        out[f"ssd chunk {chunk} with h"] = y.cpu()
        out[f"ssd chunk {chunk} h"] = h.cpu()
    cfg = get_config("zamba2-1.2b")
    model = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    tokens = torch.randint(0, cfg.vocab, (2, 1024), device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(1))
    with torch.inference_mode():
        last, cache, _ = tf.prefill(cfg, model, {"tokens": tokens}, 1100)
        out["zamba2 prefill logits"] = last.cpu()
        for part, tensors in (("groups", cache["groups"]),
                              ("shared", cache["shared"])):
            for name, t in tensors.items():
                out[f"zamba2 cache {part} {name}"] = t.cpu()
        out["zamba2 forward logits"] = tf.forward(
            cfg, model, {"tokens": tokens[:, :512]}).cpu()
    cfg = get_config("whisper-small")
    if cfg.family in tf.FAMILIES:
        del model, cache
        model = tf.init_params(cfg, torch.Generator(
            device="cuda").manual_seed(0), device="cuda")
        audio = randn(2, cfg.n_audio_frames, cfg.d_model) * 0.1
        with torch.inference_mode():
            last, cache, _ = tf.prefill(cfg, model, {
                "tokens": tokens[:, :256] % cfg.vocab,
                "audio_embeds": audio}, 448)
        out["whisper prefill logits"] = last.cpu()
        for name, t in cache.items():
            out[f"whisper cache {name}"] = t.cpu()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of the tree to compare with")
    ap.add_argument("--dump", help="(internal) save this tree's outputs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_outputs: no CUDA device is available", file=sys.stderr)
        return 2
    if args.dump:
        torch.save(cases(), args.dump)
        return 0
    other = pathlib.Path(args.other).resolve()
    outputs = []
    with tempfile.TemporaryDirectory() as tmp:
        for tree in (other, ROOT):  # each in a process of its own
            dump = pathlib.Path(tmp) / f"{len(outputs)}.pt"
            subprocess.run([sys.executable, __file__, "--dump", str(dump)],
                           check=True, env={**os.environ,
                                            "PYTHONPATH": str(tree / "src")})
            outputs.append(torch.load(dump))
    theirs, ours = outputs
    new = [k for k in ours if k not in theirs]
    differ = [k for k in ours if k in theirs
              and not torch.equal(ours[k], theirs[k])]
    print(f"{len(ours) - len(new) - len(differ)} of {len(ours) - len(new)} "
          f"outputs bit-identical to {other}; {len(new)} new: {new}")
    for k in differ:
        print(f"  DIFFERS: {k}")
    return 1 if differ or len(new) == len(ours) else 0


if __name__ == "__main__":
    sys.exit(main())

"""Serving launcher: batched requests through prefill + decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
      --preset full --batch 4 --prompt-len 1024 --new-tokens 32 \\
      --max-len 2048
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

Port of ``src/repro/launch/serve.py``: the reference's flags, plus
``--device`` (the card unless ``cpu`` is asked for; raises without CUDA
otherwise). Weights come from a ``torch.Generator`` seeded 0, prompts
from one seeded 1 (the reference's keys 0 and 1). It prints what the
reference prints, then the prefill and decode times, measured on the
device that served (CUDA events on the card), with the card's name.
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import cuda
from ..configs import get_config
from ..inference.engine import Request, ServingEngine
from ..models.transformer import init_params


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--preset", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = cuda.resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.preset == "tiny":
        cfg = cfg.tiny()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    engine = ServingEngine(cfg, params, max_len=args.max_len)
    gen = torch.Generator(device=device).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=device).tolist()
    reqs = [Request(prompt=prompts[i], max_new_tokens=args.new_tokens,
                    temperature=args.temperature)
            for i in range(args.batch)]
    t0 = time.perf_counter()
    outs = engine.generate(reqs)
    dt = time.perf_counter() - t0
    total_new = sum(len(o) for o in outs)
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"new={args.new_tokens}")
    for i, o in enumerate(outs):
        print(f"  req{i}: {o}")
    print(f"generated {total_new} tokens in {dt:.2f}s "
          f"({total_new/dt:.1f} tok/s incl. prefill+kernel builds)")
    t = engine.timings
    where = (torch.cuda.get_device_name(torch.device(device))
             if device != "cpu" else "cpu")
    per_token = t["decode_ms"] / max(t["steps"], 1)
    print(f"on {where}: prefill {t['prefill_ms']:.3f} ms, decode "
          f"{per_token:.3f} ms a token ({t['steps']} steps of batch "
          f"{args.batch})")


if __name__ == "__main__":
    main()

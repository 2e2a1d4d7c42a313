"""Training launcher: local end-to-end driver with checkpoint/restart.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --preset tiny --steps 200 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 4 --seq-len 32

Port of ``src/repro/launch/train.py``: the reference's flags, plus
``--device`` (the card unless ``cpu`` is asked for; raises without CUDA
otherwise). The loop is the reference's: async checkpointing, the
stateless data pipeline keyed by step, resume from the latest checkpoint,
bf16 compute / fp32 master params. Weights come from a
``torch.Generator`` seeded 0 (the reference's key 0 gives other numbers).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from .. import cuda
from ..checkpoint.manager import AsyncCheckpointer, CheckpointManager
from ..configs import get_config
from ..data.pipeline import DataConfig, TokenPipeline
from ..training.optimizer import OptimizerConfig
from ..training.train_step import (TrainConfig, init_train_state,
                                   make_train_step)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--preset", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    choices=["none", "dots", "full"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = cuda.resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.preset == "tiny":
        cfg = cfg.tiny()
        cfg = dataclasses.replace(cfg, name=args.arch + "-tiny")
    opt = OptimizerConfig(peak_lr=args.lr,
                          warmup_steps=max(args.steps // 20, 1),
                          total_steps=args.steps)
    tc = TrainConfig(microbatches=args.microbatches, remat=args.remat)
    step_fn = make_train_step(cfg, opt, tc)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                                    global_batch=args.global_batch), cfg)

    def fresh_state():
        return init_train_state(
            cfg, opt, torch.Generator(device=device).manual_seed(0),
            device=device)

    ckpt = None
    start = 0
    state = fresh_state()
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        ckpt = AsyncCheckpointer(mgr)
        latest = mgr.latest_step()
        if latest is not None:
            state = mgr.restore(latest, state)
            start = latest
            print(f"resumed from step {latest}")

    t0 = time.perf_counter()
    tokens_seen = 0
    for step in range(start, args.steps):
        state, metrics = step_fn(state, pipe.batch_at(step))
        tokens_seen += args.global_batch * args.seq_len
        if (step + 1) % args.log_every == 0:
            dt = time.perf_counter() - t0
            print(f"step {step+1:6d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"tok/s={tokens_seen/dt:,.0f}", flush=True)
        if ckpt and (step + 1) % args.save_every == 0:
            ckpt.save(step + 1, state)
    if ckpt:
        ckpt.save(args.steps, state)
        ckpt.wait()
        print(f"final checkpoint at step {args.steps} in {args.ckpt_dir}")


if __name__ == "__main__":
    main()

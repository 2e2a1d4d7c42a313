"""End-to-end training on the PyTorch/CUDA port: train a reduced
mamba2-130m with checkpointing, stop it, resume it from its last
checkpoint and report the loss; the port's counterpart of
``examples/train_lm.py``.

Phase 1 trains to ``--steps`` x 3/5 steps, checkpointing every
``--steps`` x 3/10; phase 2 starts afresh from the same directory, as a
restarted job would, resumes from the latest checkpoint and trains to
``--steps``. On the card the Mamba layers run the hand-written SSD
kernels; with ``--device cpu`` their plain versions.

Run: PYTHONPATH=src python examples/torch_train_lm.py [--device cpu]
    [--steps 200]
"""
import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import cuda
from repro_torch.launch.train import main as train_main


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=200,
                    help="steps in all (phase 1 stops at 3/5 of them)")
    args = ap.parse_args(argv)
    device = cuda.resolve_device(args.device)
    first = max(args.steps * 3 // 5, 1)
    every = max(args.steps * 3 // 10, 1)
    ckpt = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    common = ["--arch", "mamba2-130m", "--preset", "tiny", "--global-batch",
              "8", "--seq-len", "64", "--ckpt-dir", ckpt, "--save-every",
              str(every), "--log-every", str(max(args.steps // 10, 1)),
              "--lr", "3e-3", "--device", device]
    try:
        print(f"== phase 1: train {first} steps ==", flush=True)
        train_main(common + ["--steps", str(first)])
        print(f"\n== phase 2: 'crash' and resume to {args.steps} steps ==",
              flush=True)
        train_main(common + ["--steps", str(args.steps)])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    main()

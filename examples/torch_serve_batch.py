"""Batched serving on the PyTorch/CUDA port: prefill + decode for a batch
of requests, gemma3-1b and zamba2-1.2b at the tiny preset; the port's
counterpart of ``examples/serve_batch.py``.

On the card the prefill runs the hand-written flash-attention and SSD
kernels; with ``--device cpu`` their plain versions.

Run: PYTHONPATH=src python examples/torch_serve_batch.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import cuda
from repro_torch.launch.serve import main as serve_main


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = cuda.resolve_device(args.device)
    for arch in ("gemma3-1b", "zamba2-1.2b"):
        print(f"==== {arch} (reduced config) ====", flush=True)
        serve_main(["--arch", arch, "--preset", "tiny", "--batch", "4",
                    "--prompt-len", "12", "--new-tokens", "12",
                    "--device", device])


if __name__ == "__main__":
    main()

"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints, as the last line of standard
output, one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last
``checks``); the numbers compared for ``correct`` close standard error.
``portbench/harness.py`` says what a run does.
"""
import time

T0 = time.perf_counter()  # set-up is timed from the start of the process

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _caches(root: pathlib.Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths:
    the port builds its CUDA libraries under ``build/repro_torch`` by
    itself; PyTorch's and Triton's caches are pointed beside it."""
    base = root / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(base / "torch_kernels")


if __name__ == "__main__":
    _caches(ROOT)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import harness
    sys.exit(harness.main(sys.argv[1:], ROOT, T0))

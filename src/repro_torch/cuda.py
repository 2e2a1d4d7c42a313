"""Device selection and the build of the port's hand-written CUDA kernels.

No module of ``repro`` answers to this one: JAX picks its backend itself,
and Pallas compiles inside ``jax.jit``. Here the entry points choose their
device explicitly, and the kernels are compiled with ``nvcc`` from the
sources in the package (``*/csrc/*.cu``) into shared libraries with a
plain C interface, loaded with ``ctypes``.

Rules every entry point of the port follows:

  * ``device=None`` means the card (``"cuda"``). Without CUDA the call
    raises ``RuntimeError`` unless the caller asked for ``"cpu"``: nothing
    falls back to the CPU by itself.
  * A kernel library is built at first use into ``build/repro_torch/`` at
    the root of the checkout (one ``nvcc`` per source, all started
    together by ``build``), keyed by a hash of the source, the headers
    beside it and the flags, so an edited source or header rebuilds and
    an unchanged one loads as it is.
  * A wrapper raises when its C entry point returns a non-zero
    ``cudaGetLastError()`` after the launch. A launch the CUDA driver
    refuses before it runs (too many threads, registers or shared memory)
    is a ``LaunchRefused``; any other error is a ``RuntimeError``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time
from typing import Iterable

import torch

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR.parents[1] / "build" / "repro_torch"

# kernel name -> source, relative to the package
SOURCES = {
    "gemm": "kernels/csrc/gemm.cu",
    "convolution": "kernels/csrc/convolution.cu",
    "hotspot": "kernels/csrc/hotspot.cu",
    "dedispersion": "kernels/csrc/dedispersion.cu",
    "flash_attention": "kernels/csrc/flash_attention.cu",
    "ssd": "kernels/csrc/ssd.cu",
    "budget_scan": "core/engine_torch/csrc/budget_scan.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")
# per-kernel extra flags: the budget scan must keep every float64 add
# unfused and in source order (bit parity with the numpy engine)
EXTRA_FLAGS = {"budget_scan": ("-fmad=false",)}

# cudaError_t codes of a launch the CUDA driver refuses before it runs;
# neither is sticky, so the context stays usable after them
LAUNCH_REFUSED = {9: "cudaErrorInvalidConfiguration",
                  701: "cudaErrorLaunchOutOfResources"}

_LIBS: dict[str, ctypes.CDLL] = {}


class ConfigRejected(ValueError):
    """A tuning configuration the kernel cannot run on this card, found
    before anything was launched. A live recording stores it as a failed
    configuration."""


class LaunchRefused(ConfigRejected):
    """The CUDA driver refused the launch (``LAUNCH_REFUSED``): the kernel
    never ran and the CUDA context is unharmed."""


# ------------------------------------------------------------------ devices
def resolve_device(device: "str | torch.device | None" = None) -> str:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Raises ``RuntimeError`` when CUDA is wanted but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return "cpu"
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU (the kernels' plain PyTorch versions)")
    return str(dev)


def device_label(device: str) -> str:
    """Cache label of a device: the card's name in lower snake case
    (``NVIDIA H100 80GB HBM3`` -> ``nvidia_h100_80gb_hbm3``), or ``cpu``."""
    if torch.device(device).type == "cpu":
        return "cpu"
    name = torch.cuda.get_device_name(torch.device(device))
    return re.sub(r"[^a-z0-9]+", "_", name.lower()).strip("_")


# ------------------------------------------------------------------- builds
def toolkit(tool: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``): on PATH,
    else in ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``)."""
    exe = shutil.which(tool) or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", tool)
    if not os.path.exists(exe):
        raise RuntimeError(f"{tool} not found (looked on PATH and in "
                           f"$CUDA_HOME/bin); the CUDA kernels cannot be "
                           f"built or inspected")
    return exe


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def library_path(name: str) -> pathlib.Path:
    """Where kernel ``name``'s shared library is (or will be) built: keyed
    by the source, every header (``*.cuh``) beside it and the flags, so an
    edited header rebuilds too."""
    src = PACKAGE_DIR / SOURCES[name]
    digest = hashlib.sha256()
    for path in [src, *sorted(src.parent.glob("*.cuh"))]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output for the last build of ``name`` (ptxas registers,
    shared memory and spills), or '' when it was never built here."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names: Iterable[str] | None = None) -> dict[str, float]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns the seconds until each build
    ended (0.0 for one already built). Raises ``RuntimeError`` with
    nvcc's output when a build fails, after every nvcc has exited."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [toolkit(), *_flags(name), "-o", str(tmp),
                   str(PACKAGE_DIR / SOURCES[name])]
            log = open(out.with_suffix(".log"), "w")
            procs[name] = (subprocess.Popen(cmd, stdout=log,
                                            stderr=subprocess.STDOUT),
                           tmp, out, log)
        seconds = {name: 0.0 for name in names}
        failed = []
        for name, (proc, tmp, out, log) in procs.items():
            rc = proc.wait()
            log.close()
            seconds[name] = time.perf_counter() - t0
            if rc:
                failed.append(f"nvcc failed for {name} (exit {rc}):\n"
                              f"{build_log(name)}")
            else:
                os.replace(tmp, out)
    finally:
        for proc, _tmp, _out, log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """Kernel ``name``'s loaded library, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise for a non-zero ``cudaGetLastError()`` read after a launch."""
    if rc == 0:
        return
    msg = f"{what}: {lib.repro_error_string(rc).decode()} (cudaError {rc})"
    if rc in LAUNCH_REFUSED:
        raise LaunchRefused(f"launch refused, {msg}")
    raise RuntimeError(msg)


def stream_handle(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream

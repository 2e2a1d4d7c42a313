"""Public entry points of every kernel of the port (the ops facade).

Port of ``src/repro/kernels/ops.py``: the reference re-exports its jit'd
Pallas kernels and their ``*_ref`` oracles; this module re-exports the
port's wrappers of the hand-written CUDA kernels and their plain PyTorch
versions (``*_plain``). Each wrapper takes its tiling as keyword
arguments with the framework defaults, launches its kernel for tensors on
the card and runs its plain version for tensors on the CPU.
"""
from __future__ import annotations

from .convolution import conv2d, conv2d_plain
from .dedispersion import dedisperse, dedisperse_plain, make_delays
from .flash_attention import attention_plain, flash_attention
from .gemm import gemm, gemm_plain
from .hotspot import hotspot, hotspot_plain
from .ssd import ssd_plain, ssd_scan

__all__ = [
    "conv2d", "conv2d_plain",
    "dedisperse", "dedisperse_plain", "make_delays",
    "flash_attention", "attention_plain",
    "gemm", "gemm_plain",
    "hotspot", "hotspot_plain",
    "ssd_scan", "ssd_plain",
]

"""Operations of one call of the port's SSD scan (``csrc/ssd.cu``), and
the card's float32 rate that its header bounds it by.

``chunked_flops`` is a copy of ``chunked_flops`` (with ``needed_flops``)
in ``src/repro_torch/kernels/ssd.py``: the state products of passes 1
and 3, 4·bh·L·N·P, an FMA being 2, and per chunk the intra-chunk
products C Bᵀ (depth N) and W X (depth P) over the pairs of sub-tiles of
min(64, chunk) steps on or below the diagonal.
"""
from __future__ import annotations

F32_FLOPS_PER_S = 67e12     # NVIDIA H100 SXM5, CUDA cores, float32
SUB_ROWS = 64               # the steps of a pass-3 sub-tile


def chunked_flops(bh: int, seq: int, p: int, n: int, chunk: int) -> float:
    rows = min(SUB_ROWS, chunk)
    subs = -(-chunk // rows)
    pairs = subs * (subs + 1) // 2
    intra = bh * (seq // chunk) * pairs * 2.0 * rows * rows * (n + p)
    return 4.0 * bh * seq * n * p + intra

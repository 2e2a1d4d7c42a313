"""Bytes one launch of the budget scan moves, and the card's HBM rate.

A launch over R runs of P entries against a space of n valid configs,
each recorded, reads its inputs once and writes its outputs once:

  inputs   rows (R, P) int64, fresh (R, P) bool, col_of_row (n) int32,
           time_s and charge_s (n) float64, spent0, evals0, max_s,
           max_e (R) 8 bytes each;
  outputs  accept (R, P) bool, t_after, value and charge (R, P)
           float64, spent and evals (R) 8 bytes, exhausted (R) bool.

At R = 1,024, P = 20 on the 10,140-config GEMM space that is 949,296
bytes (0.949 MB), the count the port's chip smoke test prints beside
the kernel's time. The whole tables are counted, as there, though a
launch gathers only the rows it asks for.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12    # NVIDIA H100 SXM5 80 GB, data sheet


def launch_bytes(runs: int, popsize: int, n_valid: int) -> int:
    entries = runs * popsize
    inputs = entries * (8 + 1) + n_valid * (4 + 8 + 8) + runs * 32
    outputs = entries * (1 + 3 * 8) + runs * (8 + 8 + 1)
    return inputs + outputs


def least_seconds(runs: int, popsize: int, n_valid: int) -> float:
    """The least time a launch can take on the card: its bytes at the
    HBM rate (its float64 adds, at most R x P, take far less)."""
    return launch_bytes(runs, popsize, n_valid) / HBM_BYTES_PER_S

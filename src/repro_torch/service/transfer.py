"""Nearest-problem-shape transfer for ConfigHub lookups.

When a lookup misses the recorded index exactly, the service answers with
the best config of the *nearest recorded problem* (possibly on another
device) plus a provenance/confidence record — the classic transfer-tuning
fallback of hosted tuners (MindOpt Tuner's cold-start story,
arXiv:2307.08085).

Distance is computed in log-space over the shared numeric problem
dimensions — tile/shape optima track *ratios* (a 4096→8192 GEMM is as far
from 4096 as 4096 is from 2048), so ``ln(a/b)`` is the right metric — with
a constant penalty per non-comparable dimension (missing on one side, or
non-numeric and unequal). The result is deterministic and symmetric:
``shape_distance(a, b) == shape_distance(b, a)``.

Port copy of ``src/repro/service/transfer.py``, kept as its own copy:
the port imports nothing of ``repro``. Unchanged: the distances,
confidences and donor order are the reference's, bit for bit.
"""
from __future__ import annotations

import math
from typing import Mapping

# penalty added per problem dimension that the two shapes cannot compare
# numerically; deliberately >= 1 so "same dims, 2x scale" (distance ln 2)
# always beats "different dims entirely"
UNSHARED_PENALTY = 1.0

# a transfer from another device is trusted less than one from another
# problem shape on the same device: optima move with the compute/bandwidth
# balance (paper Sec. II) even when the shape matches exactly
CROSS_DEVICE_PENALTY = 0.5


def shape_distance(a: Mapping, b: Mapping) -> float:
    """Normalized distance between two problem-size dicts (0.0 = identical).

    RMS of ``ln(a[k]/b[k])`` over the dimensions both shapes share with
    positive numeric values, plus ``UNSHARED_PENALTY`` for every dimension
    only one side has (or both have but cannot be compared as positive
    numbers and are unequal).
    """
    shared_sq = []
    penalty = 0.0
    for k in sorted(set(a) | set(b)):
        if k not in a or k not in b:
            penalty += UNSHARED_PENALTY
            continue
        va, vb = a[k], b[k]
        numeric = (isinstance(va, (int, float)) and not isinstance(va, bool)
                   and isinstance(vb, (int, float))
                   and not isinstance(vb, bool))
        if numeric and va > 0 and vb > 0:
            shared_sq.append(math.log(va / vb) ** 2)
        elif va == vb:
            shared_sq.append(0.0)
        else:
            penalty += UNSHARED_PENALTY
    base = math.sqrt(sum(shared_sq) / len(shared_sq)) if shared_sq else 0.0
    return base + penalty


def transfer_confidence(distance: float, cross_device: bool) -> float:
    """Confidence in a transferred config, in (0, 1]: 1 at distance 0 on
    the same device, decaying with shape distance and a flat cross-device
    penalty. Exact hits report 1.0 without going through here."""
    return 1.0 / (1.0 + distance
                  + (CROSS_DEVICE_PENALTY if cross_device else 0.0))


def donor_order_key(distance: float, cross_device: bool, pkey: str,
                    device: str) -> tuple:
    """Deterministic total order for donor selection: nearest shape first,
    same-device before cross-device at equal distance, then lexicographic
    (problem_key, device) so ties never depend on index/dict order."""
    return (distance, cross_device, pkey, device)

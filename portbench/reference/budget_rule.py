"""The per-run budget of a recorded space, by the scoring methodology.

The budget is the simulated time at which the calculated random-search
baseline, the mean best-so-far of 1,000 virtual runs that sample the
recorded configs without replacement and pay each one's own charge,
first reaches 95 % of the way from the median value to the optimum.
Where the baseline does not get there within 3,000 mean charges, the
budget is that cap. The crossing is found by 48 bisections of
``[min charge, cap]``; the virtual runs' permutations come from
``numpy.random.default_rng(0xB0B ^ crc32("<kernel>@<device>"))``.

NumPy alone; the benchmark computes the number once from each frozen
recording and writes it into the configuration file.
"""
from __future__ import annotations

import zlib

import numpy as np

CUTOFF = 0.95
BASELINE_RUNS = 1000
BASELINE_SEED = 0xB0B
HARD_CAP_EVALS = 3000
BISECTIONS = 48


def virtual_random_runs(values, charges, n_runs: int, seed: int) -> tuple:
    """Improvement steps of ``n_runs`` virtual random-search runs: padded
    (times, bests), one row a run."""
    rng = np.random.default_rng(seed)
    n = len(values)
    worst = values[np.isfinite(values)].max()
    imp_t, imp_v = [], []
    for _ in range(n_runs):
        perm = rng.permutation(n)
        t = np.cumsum(charges[perm])
        v = values[perm]
        run_min = np.fmin.accumulate(np.where(np.isfinite(v), v, np.inf))
        step = np.ones(n, bool)
        step[1:] = run_min[1:] < run_min[:-1]
        step &= np.isfinite(run_min)
        imp_t.append(t[step])
        imp_v.append(run_min[step])
    k = max(len(a) for a in imp_t)
    times = np.full((n_runs, k), np.inf)
    bests = np.full((n_runs, k), worst)
    for i, (a, b) in enumerate(zip(imp_t, imp_v)):
        times[i, :len(a)] = a
        bests[i, :len(b)] = b
    return times, bests


def baseline_at(times, bests, worst_value: float, t: float) -> float:
    """Mean best-so-far of the virtual runs at simulated time ``t``; a run
    with nothing finite yet counts the worst finite value."""
    at = np.array([t], dtype=np.float64)
    counts = (times[:, :, None] <= at[None, None, :]).sum(axis=1)  # (R, 1)
    vals = np.take_along_axis(bests, np.maximum(counts - 1, 0), axis=1)
    return float(np.where(counts > 0, vals, worst_value).mean(axis=0)[0])


def budget_seconds(kernel: str, device: str, values, charges) -> float:
    """The budget of a space whose configs (in recording order) have the
    objective ``values`` (inf for a failure) and the ``charges``."""
    values = np.asarray(values, dtype=np.float64)
    charges = np.asarray(charges, dtype=np.float64)
    finite = np.sort(values[np.isfinite(values)])
    if finite.size == 0:
        raise ValueError(f"{kernel}@{device}: no successful config")
    optimum, median = float(finite[0]), float(np.median(finite))
    mean_charge = float(charges.mean())
    seed = BASELINE_SEED ^ zlib.crc32(f"{kernel}@{device}".encode())
    times, bests = virtual_random_runs(values, charges, BASELINE_RUNS, seed)
    target = median - CUTOFF * (median - optimum)
    lo, hi = float(charges.min()), float(HARD_CAP_EVALS * mean_charge)
    if baseline_at(times, bests, finite[-1], hi) > target:
        return hi
    for _ in range(BISECTIONS):
        mid = 0.5 * (lo + hi)
        if baseline_at(times, bests, finite[-1], mid) <= target:
            hi = mid
        else:
            lo = mid
    return hi

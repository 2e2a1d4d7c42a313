"""Probes of fused campaigns (src/repro_torch/core/engine_torch/campaign.py)
on the card, beside what chip_smoke.py checks: where the wall of a
device-fused ``evaluate_strategy`` and of an exhaustive GA campaign goes,
against the numpy engine's on the same recordings.

The recordings are synthetic, made from a seed, with the shape of
chip_smoke.py's live GEMM recording: 512 configurations recorded of the
GEMM's 10,140 (the rest replay as misses), three such recordings; or the
cache files named by ``--cache`` (such as the live recordings a
``chip_smoke.py`` run leaves under build/chip_smoke/), the first of them
for 1 and 2.

  1. ``evaluate_strategy`` (25 repeats, one recording) of random search,
     the GA and PSO, torch engine (device-fused) and numpy engine, in the
     order torch, numpy, numpy, torch; each wall, and for the torch runs
     the packed budget-scan calls (``ScanBlocks.run``: count, host wall
     including the copies and the synchronisation);
  2. one profile (cProfile, top entries by own time) of each strategy's
     torch run and numpy run;
  3. ``exhaustive_hypertune`` of the GA (108 configurations x 3 repeats
     x the three recordings) in the same order, each wall, the torch
     runs' launches and the wall of their packed calls.

Run from the root of the checkout on a machine with a card:

    python3 scripts/probe_campaign.py
    python3 scripts/probe_campaign.py --cache build/chip_smoke/gemm@*.json.gz ...

Each reading is one line, after the card's name and power limit; it exits
non-zero when the card is missing or a torch score differs from the numpy
engine's.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import pathlib
import pstats
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import chip_smoke  # noqa: E402

STRATEGIES = ("random_search", "genetic_algorithm", "pso")
RECORDED = 512
REPEATS = 25


def recordings(count: int) -> list:
    """``count`` GEMM-shaped recordings: 512 of 10,140 configs each."""
    from repro_torch.core.cache import CacheFile
    out = []
    for seed in range(count):
        full = chip_smoke.synthetic_gemm_cache(seed)
        keys = list(full.results)
        keep = np.random.default_rng(seed).choice(len(keys), RECORDED,
                                                  replace=False)
        out.append(CacheFile(f"gemm{seed}", "synthetic", full.space,
                             {keys[i]: full.results[keys[i]]
                              for i in sorted(keep.tolist())}))
    return out


class Calls:
    """Counts ``ScanBlocks.run`` calls and their host wall."""

    def __enter__(self) -> "Calls":
        from repro_torch.core.engine_torch import replay as rp
        self.n, self.seconds = 0, 0.0
        self.inner = inner = rp.ScanBlocks.run

        def run(blocks, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                return inner(blocks, *args, **kwargs)
            finally:
                self.n += 1
                self.seconds += time.perf_counter() - t0

        rp.ScanBlocks.run = run
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.core.engine_torch import replay as rp
        rp.ScanBlocks.run = self.inner


def top(profile: cProfile.Profile, lines: int = 8) -> str:
    buf = io.StringIO()
    pstats.Stats(profile, stream=buf).sort_stats("tottime").print_stats(lines)
    keep = [ln for ln in buf.getvalue().splitlines()
            if ln.strip() and ("(" in ln or "ncalls" in ln)]
    return "\n".join("    " + ln.strip() for ln in keep)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cache", action="append", default=[],
                    help="a T4 cache file to replay (repeatable); default "
                         "three synthetic GEMM-shaped recordings")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_campaign: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.core.cache import CacheFile
    from repro_torch.core.hypertuner import exhaustive_hypertune
    from repro_torch.core.methodology import evaluate_strategy, make_scorer
    from repro_torch.core.parallel import StrategyFactory
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    caches = ([CacheFile.load(path) for path in args.cache] if args.cache
              else recordings(3))
    chip_smoke.ends_check(caches)
    engines = ("torch", "vectorized", "vectorized", "torch")
    scores: dict = {}
    for name in STRATEGIES:
        factory = StrategyFactory.create(name, {})
        for i, engine in enumerate(engines):
            scorer = make_scorer(caches[0], engine=engine, device="cuda")
            prof = cProfile.Profile()
            with Calls() as calls:
                if i >= 2:
                    prof.enable()
                t0 = time.perf_counter()
                rep = evaluate_strategy(factory, [scorer], repeats=REPEATS,
                                        seed=0)
                wall = time.perf_counter() - t0
                prof.disable()
            scores.setdefault(name, set()).add(rep.score)
            print(f"{name} engine {engine} drive {rep.fuse}: {wall:.4f} s "
                  f"wall, {rep.fresh_evals} fresh evals; {calls.n} packed "
                  f"calls, {calls.seconds:.4f} s in them")
            if i >= 2:
                print(top(prof))
    t = {}
    for i, engine in enumerate(engines):
        scorers = [make_scorer(c, engine=engine, device="cuda")
                   for c in caches]
        with Calls() as calls:
            t0 = time.perf_counter()
            res = exhaustive_hypertune("genetic_algorithm", scorers,
                                       repeats=3, seed=0)
            wall = time.perf_counter() - t0
        t.setdefault(engine, []).append(wall)
        scores.setdefault("hypertune", set()).add(tuple(res.scores))
        print(f"hypertune GA x {len(res.results)} x 3 repeats x "
              f"{len(scorers)} recordings, engine {engine}: {wall:.4f} s "
              f"wall; {calls.n} packed calls, {calls.seconds:.4f} s in them")
    print(f"hypertune torch / numpy: "
          f"{sum(t['torch']) / sum(t['vectorized']):.4f}")
    differ = [k for k, v in scores.items() if len(v) != 1]
    if differ:
        print(f"probe_campaign: torch scores differ from numpy: {differ}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

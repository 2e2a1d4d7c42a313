#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA H100.

    python3 chip_smoke.py [--out DIR]

Run from the root of the repository: it imports ``repro_torch`` from
``src/`` (never ``jax``, nothing of ``repro``). It exits non-zero, printing
no result, when no CUDA device is present or the repository is missing.

Phases (any failure ends the script with a non-zero exit):

  1. the card's name and power limit, as ``nvidia-smi`` prints them;
  2. the build of every kernel from the ``.cu`` sources, in parallel;
  3. each kernel against its plain PyTorch version on the card: the GEMM at
     tests/test_kernels.py's shapes in float32 and bf16 and at the hub size
     4096^3 bf16 (``gemm_agrees``, element by element: float32 within
     RTOL·(|ref| + sqrt(k)), bf16 within one bf16 ulp of |ref| plus the
     float32 term), the budget scan over
     1024 runs of full-space permutations of the GEMM's 10,140 configs
     with budgets that run out mid-row (bit-identical); times by CUDA
     events (median of 10) beside each kernel's bound;
  4. the main path, part one: a live random-search recording of the GEMM
     at 4096^3 bf16 (3 repeats per config) through ``record_cache``, shard
     -> merge -> a cache file labelled with the card's name;
  5. the main path, part two: ``replay_many`` of 1024 runs over that
     cache, then ``make_scorer`` + ``evaluate_strategy`` (25 repeats) for
     random search and the genetic algorithm with the torch engine on the
     card and with the numpy engine; scores must be bit-identical.

Kernel launch counters are set to 0 just before phase 4 and read just
after phase 5; each kernel must have launched there. The line before the
last is the JSON summary of every kernel; the last line is the device
record ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): what each kernel's bound uses
PEAK_BF16_FLOPS = 989e12
PEAK_F64_FLOPS = 34e12       # float64 outside the tensor cores
PEAK_BYTES = 3.35e12
RTOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}  # tests/test_kernels.py
HUB = 4096
GEMM_SHAPES = [  # (m, n, k, block_m, block_n, block_k)
    (128, 128, 128, 64, 128, 128),
    (192, 256, 320, 96, 128, 64),
    (200, 130, 90, 64, 128, 128),
]
HUB_TILINGS = [(128, 128, 64), (96, 160, 48)]  # aligned, irregular
SCAN_RUNS = 1024
REPEATS = 25
# the live recording's budget: fresh evaluations, and measured seconds as a
# cap (a few tilings take seconds a launch; about 25 s wall in all)
RECORD_EVALS = 512
RECORD_SECONDS = 150.0


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of one ``fn()`` each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ----------------------------------------------------------------- phase 3
def gemm_agrees(out: torch.Tensor, ref: torch.Tensor, k: int,
                dtype: torch.dtype) -> tuple:
    """``(ok, max |err|, worst err/limit)`` of the GEMM kernel's output
    against the plain version's, element by element.

    float32: |err| <= RTOL·|ref| + RTOL·sqrt(k), tests/test_kernels.py's
    tolerance with a relative term of RTOL alone. bf16: both sides sum in
    float32 and round once to bf16, so an element may differ by one bf16
    rounding step of its own magnitude (one ulp of |ref|) plus the float32
    tolerance for the other summation order. Either way a zero, halved,
    truncated-K or wrong-row output fails at the hub size too."""
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    limit = RTOL[torch.float32] * (k ** 0.5 + ref.abs())
    if dtype == torch.bfloat16:
        _, exp = torch.frexp(ref)
        limit = torch.ldexp(torch.ones_like(ref), exp - 8) \
            + RTOL[torch.float32] * k ** 0.5
    worst = (diff / limit).max().item()
    return (bool((diff <= limit).all()), diff.max().item(), worst)


def check_gemm(device: str, shapes, hub: int) -> dict:
    """GEMM kernel vs ``gemm_plain`` on the card; times at the hub size."""
    from repro_torch.kernels import gemm as gm
    rng = np.random.default_rng(0)

    def operands(m, n, k, dtype):
        return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                .to(device=device, dtype=dtype)
                for s in ((m, k), (k, n), (m, n))]

    cases = [(m, n, k, t, dtype) for dtype in (torch.float32, torch.bfloat16)
             for m, n, k, *t in shapes]
    cases += [(hub, hub, hub, t, torch.bfloat16) for t in HUB_TILINGS]
    hub_err = 0.0
    for m, n, k, (bm, bn, bk), dtype in cases:
        a, b, c0 = operands(m, n, k, dtype)
        out = gm.gemm(a, b, c0, block_m=bm, block_n=bn, block_k=bk,
                      alpha=0.5, beta=1.5)
        if device != "cpu":
            torch.cuda.synchronize()
        ref = gm.gemm_plain(a, b, c0, alpha=0.5, beta=1.5)
        ok, err, worst = gemm_agrees(out, ref, k, dtype)
        print(f"  gemm {str(dtype)[6:]:8s} {m}x{n}x{k} tiles "
              f"({bm},{bn},{bk}): max |err| {err:.6g}, worst err/limit "
              f"{worst:.4g} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"gemm disagrees with gemm_plain at {m}x{n}x{k} {dtype}")
        if m == hub:
            hub_err = max(hub_err, err)
    a, b, c0 = operands(hub, hub, hub, torch.bfloat16)
    bm, bn, bk = HUB_TILINGS[0]
    ms = time_ms(lambda: gm.gemm(a, b, c0, block_m=bm, block_n=bn,
                                 block_k=bk, alpha=0.5, beta=1.5))
    plain_ms = time_ms(lambda: gm.gemm_plain(a, b, c0, alpha=0.5, beta=1.5))
    # yardstick only: one PyTorch call computing the same function
    library_ms = time_ms(lambda: torch.addmm(c0, a, b, beta=1.5, alpha=0.5))
    flops = 2.0 * hub ** 3 + 3.0 * hub * hub
    moved = nbytes(a, b, c0) + hub * hub * 2
    ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, moved / PEAK_BYTES * 1e3
    print(f"  gemm {hub}^3 bf16 ({bm},{bn},{bk}): kernel {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
          f"torch.addmm {library_ms:.4f} ms, bound {max(ops_ms, bytes_ms):.4f}"
          f" ms (operations {ops_ms:.4f}, bytes {bytes_ms:.4f})")
    return {"name": "gemm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gemm.cu",
            "replaces": "src/repro/kernels/gemm.py:40",
            "max_abs_err": hub_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": library_ms}


def synthetic_gemm_cache(seed: int = 0):
    """A full cache over the GEMM's 10,140 configs, made from a seed: the
    budget scan's input at the size the main path gives it."""
    from repro_torch.core.cache import CachedResult, CacheFile
    from repro_torch.kernels import gemm as gm
    space = gm.space()
    rng = np.random.default_rng(seed)
    n = space.size
    times = np.exp(rng.normal(-4.0, 1.0, n))
    failed = rng.random(n) < 0.3
    results = {}
    for i, conf in enumerate(space.valid_configs):
        reps = tuple((times[i] * (1 + 0.01 * rng.standard_normal(3))).tolist())
        results[space.config_id(conf)] = (
            CachedResult("error", float("inf"), (), float(rng.random()) * 1e-3)
            if failed[i] else
            CachedResult("ok", sum(reps) / 3, reps, float(times[i])))
    return CacheFile("gemm", "synthetic", space, results)


def check_scan(device: str, runs: int, seed: int = 1) -> dict:
    """Budget-scan kernel vs its plain version: bit-identical."""
    from repro_torch.core.engine_torch import replay as rp
    cache = synthetic_gemm_cache()
    compiled, cols = cache.space.compiled, cache.columns
    rng = np.random.default_rng(seed)
    n = compiled.n_valid
    rows = np.stack([rng.permutation(n) for _ in range(runs)])
    total = float(cols.charge_s.sum())
    # most budgets run out mid-row, by time or by count; every 8th run has
    # none (the no-limit stand-ins inf and 2**62)
    max_s = rng.uniform(0.2, 0.8, runs) * total
    max_e = np.where(rng.random(runs) < 0.25, rng.integers(1, n, runs),
                     2 ** 62)
    max_s[::8], max_e[::8] = np.inf, 2 ** 62
    tables = rp.replay_tables(cols, compiled, device)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    args = (dev(rows), torch.ones(rows.shape, dtype=torch.bool,
                                  device=device),
            tables.col_of_row, tables.time_s, tables.charge_s,
            cache.mean_eval_charge(),
            torch.zeros(runs, dtype=torch.float64, device=device),
            torch.zeros(runs, dtype=torch.int64, device=device),
            dev(max_s), dev(max_e.astype(np.int64)))
    got = rp.budget_scan(*args)
    want = rp.budget_scan_plain(*args)
    same = all(torch.equal(x, y) for x, y in zip(got, want))
    err = max((x.double() - y.double()).abs().nan_to_num(0.0).max().item()
              for x, y in zip(got, want) if x.is_floating_point())
    accepted = int(got[0].sum().item())
    exhausted = int(got[6].sum().item())
    print(f"  budget_scan {runs}x{n}: {accepted} commits, {exhausted} runs "
          f"exhausted mid-row; kernel vs plain "
          f"{'bit-identical' if same else 'DIFFERENT'} (max |err| {err})")
    if not same or not 0 < exhausted < runs:
        fail("budget_scan disagrees with its plain version"
             if not same else "budget_scan test budgets did not cut mid-row")
    ms = time_ms(lambda: rp.budget_scan(*args))
    plain_ms = time_ms(lambda: rp.budget_scan_plain(*args), reps=3,
                       warmup=1)
    moved = nbytes(*(a for a in args if isinstance(a, torch.Tensor)),
                   *got)
    bytes_ms = moved / PEAK_BYTES * 1e3
    ops_ms = accepted / PEAK_F64_FLOPS * 1e3
    print(f"  budget_scan {runs}x{n}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
          f"({moved / 1e6:.1f} MB moved)")
    return {"name": "budget_scan", "route": "cuda",
            "source": "src/repro_torch/core/engine_torch/csrc/budget_scan.cu",
            "replaces": "src/repro/core/engine_jax/replay.py:66",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


# ------------------------------------------------------------- phases 4-5
def record(out_dir: pathlib.Path, device: str, problem: dict, evals: int,
           max_seconds: float):
    """Live random-search recording of the GEMM through ``record_cache``."""
    from repro_torch.core.record import RecordSpec, record_cache
    from repro_torch.kernels import gemm as gm
    spec = RecordSpec.create("gemm", target=device, problem=problem,
                             strategy="random_search", repeats=3,
                             max_evals=evals, max_seconds=max_seconds,
                             seed=0)
    out = out_dir / f"gemm@{spec.device}.json.gz"
    for stale in out_dir.glob("gemm@*"):
        stale.unlink()
    space = gm.space()
    unfit = sum(not gm.fits(space.as_dict(c), torch.bfloat16)
                for c in space.valid_configs)
    print(f"  fits() rejects {unfit} of the {space.size} bf16 tilings "
          f"before launch")
    t0 = time.perf_counter()
    cache = record_cache(spec, str(out),
                         progress=lambda msg: print(f"  {msg}"))
    wall = time.perf_counter() - t0
    ok = [(r.time_s, k) for k, r in cache.results.items() if r.status == "ok"]
    errors = [k for k, r in cache.results.items() if r.status != "ok"]
    rejected = sum(not gm.fits(cache.space.as_dict(
        cache.space.config_from_id(k)), torch.bfloat16) for k in errors)
    print(f"  recorded {len(cache.results)} configs of {cache.space.size} "
          f"for gemm@{spec.device} in {wall:.1f} s: {len(ok)} ok, "
          f"{len(errors) - rejected} refused at launch, {rejected} rejected "
          f"before launch by fits()")
    if not ok:
        fail("the recording holds no ok observation")
    best, key = min(ok)
    m, n, k = problem["m"], problem["n"], problem["k"]
    print(f"  best {cache.space.as_dict(cache.space.config_from_id(key))}: "
          f"{best * 1e3:.4f} ms, {2.0 * m * n * k / best / 1e12:.2f} TFLOP/s")
    return cache, out


def replay_and_score(cache, out: pathlib.Path, device: str, runs: int,
                     repeats: int) -> None:
    """``replay_many`` over the recorded cache, then the methodology with
    the torch engine on ``device`` and with the numpy engine."""
    from repro_torch.core.cache import CacheFile
    from repro_torch.core.engine_torch import replay_many
    from repro_torch.core.methodology import evaluate_strategy, make_scorer
    from repro_torch.core.parallel import StrategyFactory
    compiled, cols = cache.space.compiled, cache.columns
    rng = np.random.default_rng(2)
    rows = np.stack([rng.permutation(compiled.n_valid) for _ in range(runs)])
    budget = float(cols.charge_s.sum()) * 2
    t0 = time.perf_counter()
    got = replay_many(cols, compiled, rows, max_seconds=budget,
                      mean_charge=cache.mean_eval_charge(), device=device)
    got = [x.cpu() for x in got]
    wall = time.perf_counter() - t0
    want = replay_many(cols, compiled, rows, max_seconds=budget,
                       mean_charge=cache.mean_eval_charge(), device="cpu")
    if not all(torch.equal(x, y) for x, y in zip(got, want)):
        fail("replay_many on the card differs from the CPU replay")
    print(f"  replay_many {runs}x{compiled.n_valid} on the recording: "
          f"{int(got[0].sum())} commits in {wall:.3f} s wall, "
          f"{int(got[6].sum())} runs exhausted; matches the CPU replay")
    loaded = CacheFile.load(str(out))
    for name in ("random_search", "genetic_algorithm"):
        factory = StrategyFactory.create(name, {})
        reports = {}
        for engine in ("torch", "vectorized"):
            scorer = make_scorer(loaded, engine=engine, device=device)
            reports[engine] = evaluate_strategy(factory, [scorer],
                                                repeats=repeats, seed=0)
            r = reports[engine]
            print(f"  {name:17s} engine {engine:10s} score {r.score!r} "
                  f"({r.fresh_evals} fresh evals, {r.simulated_seconds!r} "
                  f"simulated s in {r.wall_seconds:.3f} s wall)")
        a, b = reports["torch"], reports["vectorized"]
        if (a.score, a.fresh_evals, a.simulated_seconds) != \
                (b.score, b.fresh_evals, b.simulated_seconds) \
                or not np.array_equal(a.curve, b.curve):
            fail(f"{name}: torch-engine scores differ from the numpy engine")


# ----------------------------------------------------------------- driver
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "chip_smoke"),
                    help="directory for the recording (default "
                         "build/chip_smoke)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import cuda
    from repro_torch.core.engine_torch import replay as rp
    from repro_torch.kernels import gemm as gm

    device = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    print("[1] card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"capability {torch.cuda.get_device_capability(0)}")

    print("[2] build")
    t0 = time.perf_counter()
    secs = cuda.build()
    print(f"  built {sorted(secs)} in {time.perf_counter() - t0:.2f} s "
          f"(per kernel: {secs})")
    for name in sorted(secs):
        for line in cuda.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    print("[3] kernels against their plain versions")
    kernels = [check_gemm(device, GEMM_SHAPES, HUB),
               check_scan(device, SCAN_RUNS)]

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    gm.launches = 0
    rp.launches = 0
    print("[4] main path: live recording of the GEMM at 4096^3 bf16")
    cache, out = record(out_dir, device, {"m": HUB, "n": HUB, "k": HUB},
                        RECORD_EVALS, RECORD_SECONDS)
    gemm_launches = gm.launches
    print("[5] main path: replay and scoring")
    replay_and_score(cache, out, device, SCAN_RUNS, REPEATS)
    launches = {"gemm": gm.launches, "budget_scan": rp.launches}
    print(f"  launches on the main path: {launches}")
    if not gemm_launches or not all(launches.values()):
        fail(f"a kernel of the main path never launched: {launches}")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

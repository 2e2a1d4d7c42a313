"""Probes of the budget scan (src/repro_torch/core/engine_torch/csrc/
budget_scan.cu) on the card, beside what chip_smoke.py checks:

  1. the latencies its R = 1 floor rests on (``chip_smoke.latency_ns``):
     one dependent global load that hits L2 and one dependent float64
     add;
  2. copies of the kernel's source with one part changed (``PROBES``),
     each a text edit that must match the source, built one nvcc each, all
     started together, into build/probe_scan/, with ptxas' registers; each
     driven through ``budget_scan`` (its library put in place of the
     package's) on chip_smoke.py's inputs, 1024 runs x 10,140 entries
     (CUDA events, median of 10), and at R = 1 x 16 / 32 (the kernel's
     device time by ``torch.profiler``), in two rounds of opposite order.
     A copy that keeps the arithmetic (``SAME_RESULT``) is held
     bit-identical to ``budget_scan_plain``; an ablated one is wrong by
     design and is not checked;
  3. ``commit_rows``' host wall per call at R = 1 x 16 / 32
     (``chip_smoke.commit_rows_ms``, 300 calls).

Run from the root of the checkout on a machine with a card:

    python3 scripts/probe_scan.py                      # 1-3
    python3 scripts/probe_scan.py --commit-only --src DIR/src

The second form measures only 3, with the ``repro_torch`` package found
under ``DIR/src`` (another checkout, such as a parent commit's). Each
reading is one line, with the card's name and power limit first; it exits
non-zero when the card is missing, a build fails or a copy that keeps the
arithmetic disagrees.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "build" / "probe_scan"
LENGTHS = (16, 32)
RUNS = 1024

WALK = """    if (lane == 0) {
      double t = spent;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (32 * s >= len) break;
#pragma unroll
        for (int l = 0; l < 32; ++l) {
          if ((fm[s] >> l) & 1u) t = __dadd_rn(t, chain[32 * s + l]);
          chain[32 * s + l] = t;
        }
      }
    }"""
SHUFFLE_WALK = """    {
      double t = spent;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (32 * s >= len) break;
#pragma unroll
        for (int l = 0; l < 32; ++l) {
          const double cl = __shfl_sync(kAll, c[s], l);
          if ((fm[s] >> l) & 1u) t = __dadd_rn(t, cl);
          if (lane == 0) chain[32 * s + l] = t;
        }
      }
    }"""
# name -> edits (text of the source, its replacement; every occurrence)
PROBES = {
    "unchanged": [],
    "charges by shuffle, every lane walking": [(WALK, SHUFFLE_WALK)],
    "walk waits for the next chunk's rows": [
        ("      double t = spent;\n#pragma unroll",
         "      double t = row[0] == -1 ? 0.0 : spent;\n#pragma unroll")],
    "1 slot (chunks of 32)": [("constexpr int kSlots = 4;",
                               "constexpr int kSlots = 1;")],
    "8 slots (chunks of 256)": [("constexpr int kSlots = 4;",
                                 "constexpr int kSlots = 8;")],
    "1 warp a block": [("constexpr int kWarps = 4;",
                        "constexpr int kWarps = 1;")],
    "8 warps a block": [("constexpr int kWarps = 4;",
                         "constexpr int kWarps = 8;")],
    "no walk": [("    if (lane == 0) {\n      double t = spent;",
                 "    if (false) {\n      double t = spent;")],
    "no col_of_row gather": [("col_of_row[row[s]]",
                              "static_cast<int32_t>(row[s])")],
}
SAME_RESULT = ("unchanged", "charges by shuffle, every lane walking",
               "walk waits for the next chunk's rows",
               "1 slot (chunks of 32)", "8 slots (chunks of 256)",
               "1 warp a block", "8 warps a block")

def _nvcc(src: pathlib.Path, lib: pathlib.Path, extra=()) -> subprocess.Popen:
    from repro_torch import cuda
    return subprocess.Popen(
        [cuda.toolkit(), *cuda.NVCC_FLAGS, *extra, "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build() -> dict:
    """Every probe's library and its ptxas line, ``name -> (library,
    'R registers, S B spilled')``."""
    from repro_torch import cuda
    src = (cuda.PACKAGE_DIR / cuda.SOURCES["budget_scan"]).read_text()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(PROBES.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu = OUT_DIR / f"probe{i}.cu"
        cu.write_text(text)
        lib = cu.with_suffix(".so")
        procs[name] = (_nvcc(cu, lib, cuda.EXTRA_FLAGS["budget_scan"]), lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = sum(map(int, re.findall(r"(\d+) bytes spill stores", log)))
        built[name] = (lib, f"{regs[0] if regs else '?'} registers, "
                            f"{spills} B spilled")
    return built


def use(path: pathlib.Path) -> None:
    """Put the library at ``path`` in place of the package's budget-scan
    library (``replay._lib`` sets its argument types at the next call)."""
    from repro_torch import cuda
    lib = ctypes.CDLL(str(path))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    cuda._LIBS["budget_scan"] = lib


def commit_walls(label: str) -> None:
    from chip_smoke import COMMIT_BATCHES, commit_rows_ms, synthetic_gemm_cache
    cache = synthetic_gemm_cache()
    for length in LENGTHS:
        med, lo, hi, _first = commit_rows_ms(cache, length, COMMIT_BATCHES,
                                             "cuda")
        print(f"{label} commit_rows R = 1 x {length}: wall per call median "
              f"{med:.4f} ms, min {lo:.4f}, max {hi:.4f} "
              f"({COMMIT_BATCHES} calls)", flush=True)


def ablations() -> None:
    from chip_smoke import (kernel_device_ms, latency_ns, scan_inputs,
                            start_latency_build, time_ms)
    from repro_torch.core.engine_torch import replay as rp
    load, add = latency_ns(start_latency_build())
    print(f"latency: dependent L2 load {load:.1f} ns, dependent float64 add "
          f"{add:.3f} ns", flush=True)
    built = build()
    _cache, args = scan_inputs("cuda", RUNS)
    want = rp.budget_scan_plain(*args)
    for rnd, names in enumerate((list(PROBES), list(PROBES)[::-1])):
        for name in names:
            lib, regs = built[name]
            use(lib)
            got = rp.budget_scan(*args)
            check = ""
            if name in SAME_RESULT:
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise SystemExit(f"{name}: differs from the plain scan")
                check = ", bit-identical"
            ms = time_ms(lambda: rp.budget_scan(*args))
            r1 = []
            for length in LENGTHS:
                one = (args[0][:1, :length].contiguous(),
                       args[1][:1, :length], *args[2:6],
                       *(t[:1] for t in args[6:]))
                k = kernel_device_ms(lambda: rp.budget_scan(*one),
                                     "budget_scan_kernel")
                r1.append("not measured" if k is None else f"{k:.4f}")
            print(f"round {rnd} {name} ({regs}): {RUNS}x{args[0].shape[1]} "
                  f"{ms:.4f} ms; R = 1 x {LENGTHS[0]} / {LENGTHS[1]} kernel "
                  f"{' / '.join(r1)} ms{check}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--commit-only", action="store_true",
                    help="measure only commit_rows' wall per call")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory that holds the repro_torch package")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(pathlib.Path(args.src).resolve())]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    import repro_torch
    print(f"repro_torch from {pathlib.Path(repro_torch.__file__).parent}",
          flush=True)
    if not args.commit_only:
        ablations()
    commit_walls(args.src)
    return 0


if __name__ == "__main__":
    sys.exit(main())

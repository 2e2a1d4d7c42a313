"""Probes of the SSD scan's three kernels (src/repro_torch/kernels/csrc/
ssd.cu) on the card, beside what chip_smoke.py checks, at mamba2-130m's
width (24 heads x 8 sequences of 4096 steps, P 64, N 128, float32):

  1. copies of the source with one part taken out or one shape changed
     (``PROBES``), each a text edit found in the source, built one nvcc
     each, all started together, into build/probe_ssd/, with the
     registers of the chunk-states and chunk-outputs kernels from ptxas;
  2. each copy driven through ``ssd.ssd_scan`` (its library put in place
     of the package's) at chunk 128, every pass timed by CUDA events
     (``chip_smoke.ssd_pass_ms``, median of 10), in two rounds of
     opposite order, the unchanged
     source also at chunks 64 and 512. A copy that keeps the arithmetic
     (``SAME_RESULT``) is held against ``ssd_plain`` within 3e-3; an
     ablated one is wrong by design and is not checked.

Run from the root of the checkout on a machine with a card:

    python3 scripts/probe_ssd.py

It prints one line a reading, with the card's name and power limit
first, and exits non-zero when the card is missing, a build fails or a
copy that keeps the arithmetic disagrees.
"""
from __future__ import annotations

import ctypes
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chip_smoke import ssd_pass_ms  # noqa: E402
from repro_torch import cuda  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402

PROBLEM = {"bh": 24 * 8, "seq": 4096, "p": 64, "n": 128}
CHUNKS = (128, 64, 512)
TOL = 3e-3
OUT_DIR = cuda.BUILD_DIR.parent / "probe_ssd"
# name -> edits (text of the source, its replacement; every occurrence)
PROBES = {
    "unchanged": [],
    "3 blocks an SM in chunk outputs (16-deep k-slices)": [
        ("constexpr int kK = 32;", "constexpr int kK = 16;"),
        ("__launch_bounds__(kThreads, 2)\nssd_chunk_outputs",
         "__launch_bounds__(kThreads, 3)\nssd_chunk_outputs")],
    "64-step slices in chunk states": [
        ("constexpr int kK1 = 32;", "constexpr int kK1 = 64;")],
    "4 ring slots in chunk states": [
        ("constexpr int kSlots1 = 3;", "constexpr int kSlots1 = 4;")],
    "4 ring slots in chunk outputs": [
        ("constexpr int kSlots3 = 3;", "constexpr int kSlots3 = 4;")],
    "chunk outputs in chunk order (sub-tiles of a chunk together)": [
        ("const int sub = subs - 1 - static_cast<int>(blockIdx.x) / per_sub;",
         "const int sub = subs - 1 - static_cast<int>(blockIdx.x) % subs;"),
        ("const int rest = static_cast<int>(blockIdx.x) % per_sub;",
         "const int rest = static_cast<int>(blockIdx.x) / subs;")],
    "no C B^T product": [
        ("for (int kk = 0; kk < kK; kk += 4) {\n        float4 cv[8], bv[4];",
         "for (int kk = 0; kk < 0; kk += 4) {\n        float4 cv[8], bv[4];")],
    "no C h_in product": [
        ("for (int kk = 0; kk < kK; kk += 4) {\n        float4 cv[8], hv[4];",
         "for (int kk = 0; kk < 0; kk += 4) {\n        float4 cv[8], hv[4];")],
    "no W X product": [
        ("for (int j = 0; j < kK; ++j) {\n        const float4 w0",
         "for (int j = 0; j < 0; ++j) {\n        const float4 w0")],
    "no products in chunk outputs (its loads, mask and stores)": [
        ("for (int kk = 0; kk < kK; kk += 4) {\n        float4 cv[8], bv[4];",
         "for (int kk = 0; kk < 0; kk += 4) {\n        float4 cv[8], bv[4];"),
        ("for (int kk = 0; kk < kK; kk += 4) {\n        float4 cv[8], hv[4];",
         "for (int kk = 0; kk < 0; kk += 4) {\n        float4 cv[8], hv[4];"),
        ("for (int j = 0; j < kK; ++j) {\n        const float4 w0",
         "for (int j = 0; j < 0; ++j) {\n        const float4 w0")],
    "C loads halved": [("c_rows + r * cp + k0 + kk)",
                        "c_rows + r / 2 * 2 * cp + k0 + kk)")],
    "B loads halved": [("slot + (tx + 16 * w) * kBPitch3 + kk)",
                        "slot + (tx + 16 * (w / 2 * 2)) * kBPitch3 + kk)")],
    "no mask exp": [("g[r][w] * expf(ci_cum[r] - cj[w]) * dj[w]",
                     "g[r][w] * dj[w]")],
    "no block barrier a slice in chunk outputs": [
        ("__syncthreads();  // everyone's; slot (u - 1) % kSlots3",
         "__syncwarp();  // everyone's; slot (u - 1) % kSlots3")],
    "no product in chunk states": [
        ("for (int j = 0; j < kK1; ++j) {\n      const float w = ws[j];",
         "for (int j = 0; j < 0; ++j) {\n      const float w = ws[j];")],
}
SAME_RESULT = ("unchanged", "3 blocks an SM in chunk outputs (16-deep "
               "k-slices)", "64-step slices in chunk states",
               "4 ring slots in chunk states", "4 ring slots in chunk outputs",
               "chunk outputs in chunk order (sub-tiles of a chunk together)")


def build() -> dict[str, tuple[pathlib.Path, str]]:
    """Every probe's library and its registers, ``name -> (library,
    'states R1, outputs R3 registers, S B spilled')``."""
    src = (cuda.PACKAGE_DIR / cuda.SOURCES["ssd"]).read_text()
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
        procs[name] = (subprocess.Popen(
            [cuda.toolkit(), *cuda.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = {k: re.findall(rf"{k}E.*?Used (\d+) registers", log, re.S)
                for k in ("ssd_chunk_states", "ssd_chunk_outputs")}
        spills = sum(map(int, re.findall(r"(\d+) bytes spill stores", log)))
        built[name] = (lib, f"states {regs['ssd_chunk_states'][0]}, outputs "
                            f"{regs['ssd_chunk_outputs'][0]} registers, "
                            f"{spills} B spilled")
    return built


def use(path: pathlib.Path) -> None:
    """Put the library at ``path`` in place of the package's SSD library
    (``ssd._lib`` sets its argument types at the next call)."""
    lib = ctypes.CDLL(str(path))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    cuda._LIBS["ssd"] = lib


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    built = build()
    args = ssd.live_inputs(PROBLEM, "cuda")
    refs = {}
    for rnd, names in enumerate((list(PROBES), list(PROBES)[::-1])):
        for name in names:
            lib, regs = built[name]
            use(lib)
            for chunk in CHUNKS if name == "unchanged" else CHUNKS[:1]:
                check = ""
                if name in SAME_RESULT:
                    if chunk not in refs:
                        refs[chunk] = ssd.ssd_plain(*args, chunk=chunk)
                    out = ssd.ssd_scan(*args, chunk=chunk)
                    torch.testing.assert_close(out, refs[chunk], rtol=TOL,
                                               atol=TOL)
                    check = (f", max |err| "
                             f"{(out - refs[chunk]).abs().max().item():.3g}")
                t = ssd_pass_ms(args, chunk)
                print(f"round {rnd} {name} ({regs}), chunk {chunk}: chunk "
                      f"states {t[0]:.4f}, state pass {t[1]:.4f}, chunk "
                      f"outputs {t[2]:.4f}, total {sum(t):.4f} ms{check}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Probes of the flash-attention kernel (src/repro_torch/kernels/csrc/
flash_attention.cu) on the card, beside what chip_smoke.py checks, at
starcoder2-7b's width (36 q heads over 4 kv heads, 4096 tokens, d 128,
causal, float32):

  1. both block shapes the kernel is built for, WIDE (256 threads, 64-row
     kv sub-tiles) and NARROW (128 threads, 32-row kv sub-tiles), at the
     tilings (128,128) and (64,128), launched through the library's C
     entry (``plan`` picks one shape a tiling), each held against
     ``attention_plain`` within 2e-4 and timed;
  2. the SM clock, its maximum and the power, read by ``nvidia-smi`` from
     a thread while (128,128) runs, and the float32 FMA rate at that
     clock (128 FMAs a clock an SM);
  3. ablations: copies of the kernel source with one part taken out
     (``ABLATIONS``), built for the WIDE d-128 block only, registers read
     from ptxas, and timed at (128,128) against the unchanged source built
     the same way, in two rounds of opposite order. An ablated kernel's
     output is wrong by design and is not checked.

Run from the root of the checkout on a machine with a card:

    python3 scripts/probe_attention.py

It builds into build/probe_attention/ and prints one line a reading,
with the card's name and power limit first; it exits non-zero when the
card is missing, a build fails or a block shape disagrees.
"""
from __future__ import annotations

import ctypes
import pathlib
import re
import statistics
import subprocess
import sys
import threading

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import cuda  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

BH, BH_KV, S, D = 36, 4, 4096, 128
TILINGS = [(128, 128), (64, 128)]
RTOL = 2e-4
OUT_DIR = cuda.BUILD_DIR.parent / "probe_attention"
# the ablated parts: name -> (text of the source, its replacement), each
# text found exactly once
ABLATIONS = {
    "no score product": [("for (int dd = 0; dd < D; dd += 4) {",
                          "for (int dd = 0; dd < 0; dd += 4) {")],
    "no p v product": [("for (int j = 0; j < SKV; ++j) {",
                        "for (int j = 0; j < 0; ++j) {")],
    "q loads halved": [("q_rows + r * NG * P + dd)",
                        "q_rows + r / 2 * 2 * NG * P + dd)")],
    "k loads halved": [("ks + (c * kLanes + t) * P + dd)",
                        "ks + (c / 2 * 2 * kLanes + t) * P + dd)")],
    "v loads halved": [("vs + j * P + col0 + c * 64 + 4 * pl)",
                        "vs + j / 2 * 2 * P + col0 + c * 64 + 4 * pl)")],
    "p loads halved": [("p_pair + j * kRows)", "p_pair + j / 2 * 2 * kRows)"),
                       ("p_pair + PS + j * kRows)",
                        "p_pair + PS + j / 2 * 2 * kRows)")],
    "no exp": [("const float p = __expf(sc[r][c] - m_new);",
                "const float p = sc[r][c] - m_new;")],
    "no alpha rescale": [("acc[r][e] *= lo;\n"
                          "          acc[kRows + r][e] *= hi;", "")],
    "no block barrier a half": [("__syncthreads();     // everyone's",
                                 "__syncwarp();     // everyone's")],
}
# every probe build holds only the WIDE d-128 block
ONLY_WIDE = ("REPRO_ATTN_CASE(128, 256, 64) REPRO_ATTN_CASE(128, 128, 32)\n"
             "  REPRO_ATTN_CASE(64, 256, 64) REPRO_ATTN_CASE(64, 128, 32)",
             "REPRO_ATTN_CASE(128, 256, 64)")


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


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def launcher(lib: ctypes.CDLL, q, k, v, out, threads: int, sub_kv: int):
    """``fn(block_q, block_kv)`` launching ``lib``'s kernel with that
    block shape on the problem's tensors."""
    lib.repro_flash_attention.restype = ctypes.c_int
    lib.repro_flash_attention.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_float]
        + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream().cuda_stream

    def fn(block_q: int, block_kv: int) -> None:
        rc = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
            BH, S, S, S, D, BH // BH_KV, block_q, block_kv, 1, -1,
            1.0 / D ** 0.5, 0, D,
            threads, sub_kv, stream)
        if rc:
            raise RuntimeError(f"launch refused: cudaError {rc}")

    return fn


def build_ablations() -> dict[str, tuple[pathlib.Path, int]]:
    """Build the unchanged source and every ablation, one nvcc each, all
    started together; ``name -> (library, registers of the float32 WIDE
    d-128 instantiation)``."""
    src = (cuda.PACKAGE_DIR / cuda.SOURCES["flash_attention"]).read_text()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate({"unchanged": [], **ABLATIONS}.items()):
        text = src
        for old, new in [ONLY_WIDE, *edits]:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in the source "
                                   f"exactly once")
            text = text.replace(old, new)
        cu = OUT_DIR / f"ablation{i}.cu"
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
        regs = re.findall(r"attn_kernelILi0ELi128ELi256ELi64E.*?Used (\d+) "
                          r"registers", log, re.S)
        built[name] = (lib, int(regs[0]) if regs else -1)
    return built


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(smi("name,power.limit"))
    gen = torch.Generator(device="cuda").manual_seed(6)
    q = torch.randn((BH, S, D), generator=gen, device="cuda")
    k = torch.randn((BH_KV, S, D), generator=gen, device="cuda")
    v = torch.randn((BH_KV, S, D), generator=gen, device="cuda")
    out = torch.empty_like(q)
    ref = fa.attention_plain(q, k, v, causal=True)
    flops = 4.0 * BH * S * S * D * 0.5

    # 1. both block shapes at (128,128) and (64,128)
    lib = fa._lib()
    for bq, bkv in TILINGS:
        for label, (threads, sub_kv) in (("WIDE", fa.WIDE),
                                         ("NARROW", fa.NARROW)):
            fn = launcher(lib, q, k, v, out, threads, sub_kv)
            fn(bq, bkv)
            err = (out - ref).abs().max().item()
            torch.testing.assert_close(out, ref, rtol=RTOL, atol=RTOL)
            ms = time_ms(lambda: fn(bq, bkv))
            print(f"shape ({bq},{bkv}) {label} {threads} threads, sub_kv "
                  f"{sub_kv}: {ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s), "
                  f"max |err| {err:.3g}, plan picks "
                  f"{fa.plan(bq, bkv, S, D).threads} threads")
    del ref

    # 2. the SM clock under load, read while (128,128) runs: the card
    # stays busy, ten launches at a time, until the reading is back
    readings = []
    reader = threading.Thread(target=lambda: readings.append(
        smi("clocks.sm,clocks.max.sm,power.draw")))
    run = launcher(lib, q, k, v, out, *fa.WIDE)
    for _ in range(20):
        run(128, 128)
    reader.start()
    while reader.is_alive():
        for _ in range(10):
            run(128, 128)
        torch.cuda.synchronize()
    reader.join()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(readings[0].split(",")[0].split()[0])
    print(f"under (128,128): SM clock, max SM clock, power: {readings[0]}; "
          f"float32 rate at that clock {sms * 256 * mhz / 1e6:.1f} TFLOP/s "
          f"({sms} SMs)")

    # 3. ablations at (128,128), WIDE, d 128
    built = build_ablations()
    fns = {name: launcher(ctypes.CDLL(str(path)), q, k, v, out, *fa.WIDE)
           for name, (path, _) in built.items()}
    for rnd, order in enumerate((list(fns), list(fns)[::-1])):
        for name in order:
            ms = time_ms(lambda: fns[name](128, 128))
            print(f"ablation round {rnd} {name} ({built[name][1]} "
                  f"registers): {ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())

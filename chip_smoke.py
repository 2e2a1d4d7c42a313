#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA H100.

    python3 chip_smoke.py [--out DIR]

Run from the root of the repository: it imports ``repro_torch`` from
``src/`` (never ``jax``, nothing of ``repro``). It exits non-zero, printing
no result, when no CUDA device is present or the repository is missing.

Phases (any failure ends the script with a non-zero exit):

  1. the card's name and power limit, as ``nvidia-smi`` prints them;
  2. the build of every kernel from the ``.cu`` sources, in parallel, a
     check that the GEMM library's SASS holds wgmma (``HGMMA``) and TMA
     (``UTMALDG``) instructions, and ptxas' registers and spills of each
     (G, T) instantiation of the dedispersion kernel, each (filter
     width, R) instantiation of the convolution kernel, each R
     instantiation of the hotspot kernel, each (bf16, d_max, threads,
     sub_kv) instantiation of the flash-attention kernel and each of the
     SSD's three kernels (a spill fails);
  3. each kernel against its plain PyTorch version on the card: the GEMM at
     tests/test_kernels.py's shapes in float32 and bf16 and at the hub size
     4096^3 bf16 at six tilings (the hub's, an irregular one, and four
     classes of the bf16 launch plan; each plan printed, each tiling
     timed) and at the unaligned 4095x4093x4090 that the wrapper pads
     (``gemm_agrees``, element by element: float32 within
     RTOL·(|ref| + sqrt(k)), bf16 within one bf16 ulp of |ref| plus the
     float32 term); the convolution bit-identical at tests/test_kernels.py's
     shapes (one 130 wide), with a filter width read at run time, and at
     the hub size at five tilings, each with its launch plan printed and
     timed, beside the no-contraction floor; hotspot bit-identical at its
     test shape (t_block 1, 2, 4) and at the hub size at (64,512) with
     t_block 4, 1 and 16 and at (8,128,3), (256,1024,8) and
     (1024,4096,16), each with its launch plan printed and timed, beside
     the bytes bound and the on-chip floor; dedispersion
     bit-identical at its test
     shape (also with an adversarial delay table and with ntime not a
     multiple of 4) and at the hub size at five tilings, each with its
     launch plan printed and timed, and with the adversarial table at two
     of them, beside the shared-memory floor; flash attention at its test
     shapes
     (GQA group 2; causal, non-causal, window 64; float32 and bf16, RTOL)
     and at starcoder2-7b's width (36 q heads over 4 kv heads, 4096
     tokens, d 128, float32, causal) at (128,128), (64,128), (256,512)
     and (1024,2048), each with its launch plan printed and timed; the
     d_max 256 instantiations at d 256 (float32 and bf16, causal, window
     64, GQA 3) and at gemma3-1b's width (4 q heads over 1 kv head, 4096
     tokens, d 256, causal, and with the window 512 of its local layers),
     timed; the SSD scan at its test shapes (chunks 32, 64, 128), at a
     state of 256 and P 80 (chunks 64, 512) and at mamba2-130m's width (24
     heads x 8 sequences of 4096, P 64, N 128) at chunks 128, 64 and 512,
     within 3e-3 (the final state too, at the test shapes and at chunk
     128), each timed whole and pass by pass (chunk states, state
     pass, chunk outputs) beside the operations bound and the chunked
     algorithm's floor; the budget scan over 1024 runs of full-space
     permutations of the GEMM's 10,140 configs with budgets that run out
     mid-row (bit-identical), and at R = 1 on the segment lengths phase 6
     sends, with no cap and with a cap by time and by count that refuses
     mid-segment (bit-identical), timed there beside a latency floor
     (three dependent L2 loads and n dependent float64 adds, measured by
     a probe kernel built beside the others) and the host wall of one
     ``commit_rows`` call of that many fresh rows (median, min, max of
     300), and one ``commit_rows`` call with a cap through its packed
     blocks (one launch, bit-identical to the plain version fed the
     blocks); times by CUDA events (median of 10) beside each
     kernel's bound and, where one PyTorch call computes the same
     function, that call's time;
  4. the main path, part one: a live random-search recording of each hub
     kernel at its hub size (GEMM 4096^3 bf16, convolution 4096^2 with a
     17x17 filter, hotspot 4096^2, dedispersion 256 channels x 16384
     samples x 256 dms; the number of evaluations cut per kernel) and of
     each framework kernel at its full width over its whole space (flash
     attention 50 configs, SSD 30), 3 repeats per config, through
     ``record_cache``, shard -> merge -> a cache file labelled with the
     card's name; each recording's per-config time (min, median, max) and
     its fastest and slowest tilings;
  5. the main path, part two: the guard (``cap_guard``: every strategy
     that is not device-fused driven over each recording on the numpy
     engine, its 25 runs as the methodology seeds them; a recording on
     which a run asks 100,000 times in a row with no fresh config is
     left out of that strategy's scoring and printed as that fault);
     ``replay_many`` of 1024 runs over the GEMM's recording;
     ``drive_many(fuse="device")`` of random search, the GA, PSO and
     differential evolution (25 runs each, the methodology's budget) on
     the card against the numpy ``drive_many``, each runner's trace, memo
     keys, budget floats and exhaustion bit-identical; then
     ``make_scorer`` + ``evaluate_strategy`` (25 repeats) for all nine
     strategies, on the GEMM's recording and on all six (Eq. 3
     aggregate), with the torch engine on the card (device-fused for
     random search, the GA, PSO and DE; the host drive for SA, basin
     hopping, greedy ILS and MLS; sequential for dual annealing) and with
     the numpy engine; scores must be bit-identical; each report's drive
     mode and budget-scan launches (a strategy that committed a fresh
     row without a launch fails), and the host-driven strategies' asks a
     run and wall an ask on both engines (counted around ``ask`` here);
  6. the main path, part three: ``exhaustive_hypertune`` of the genetic
     algorithm over its 108-point Table III grid across the six
     recordings (3 repeats, cut from the paper's 25), torch engine
     (device-fused), then the same campaign on the numpy engine twice and
     on the torch engine again (the walls compare in turns): all 108
     scores of each must be bit-identical; each wall, the torch runs'
     budget-scan launches, their R and segment lengths and the packed
     calls' host wall; the best,
     closest-to-mean and worst hyperconfigurations are rescored with the
     numpy engine and must be bit-identical; then the paper's
     meta-strategy path (Eq. 4): ``meta_hypertune`` of the GA over its
     extended grid with dual annealing as the meta-strategy (through the
     thread bridge; 50 configurations, 3 repeats, journaled), torch
     engine then numpy engine, every score and the best configuration
     bit-identical, no bridge thread left;
  7. the main path, part four: serving zamba2-1.2b at full width
     (``SERVE_ARCH``; 38 Mamba2 layers, 6 calls of the shared attention
     block a prefill), random float32 weights from a seeded generator,
     cast to bf16 where used: (a) the model built on the card; (b) one
     prefill of the 4 x 1024 prompts with the inputs of its first SSD
     call and its first flash-attention call captured, each kernel held
     against its plain version on the card at those shapes (the SSD's y
     and final state within 3e-3, attention within the bf16 RTOL), timed
     beside the plain version, SDPA and the bound, and the prefill's
     launches exactly 6 and 38; (c) prefill of 1023 tokens against
     ``forward`` (0.05) and one decode step against ``forward``'s last
     position (0.3 of the logits' spread), tests/test_models.py's
     tolerances; (d) ``ServingEngine.generate`` of 4 requests of 1024
     tokens, 32 new tokens each, max_len 2048, with every launch counter
     set to 0 before and read after: exactly 6 flash-attention and 38
     SSD launches and no other; (e) prefill ms and decode ms a token by
     CUDA events, tokens/s, peak memory, and the kernels' share of a
     prefill's device time by ``torch.profiler`` with its largest
     kernels, each beside the card's name and power limit;
  8. the main path, part five: training zamba2-1.2b at full width
     (``TRAIN_ARCH``), random float32 weights from a seeded generator,
     ``TokenPipeline`` batches of 4 x 1024 tokens, remat full, AdamW
     (peak lr 3e-4, warmup 2), 8 steps: (a) in step 0 the inputs of the
     first flash-attention and the first SSD call captured; at those
     shapes the kernel's lse against the plain logsumexp (float32 RTOL)
     and the SSD's chunk states against ``ssd_plain``'s (3e-3), and each
     call site's autograd Function (kernel forward, PyTorch backward)
     against autograd through ``attention_plain`` / ``ssd_plain`` on the
     card (output and every input gradient by relative error, bf16 RTOL
     and 3e-3), each forward, backward and the plain forward + backward
     timed; (b) every launch counter set to 0 around step 1: exactly 6
     flash-attention launches (the shared block is not rematerialised)
     and 76 SSD launches (38 forward, 38 in the recompute), no other; (c)
     the loss finite at every step and lower at the last than at the
     first; (d) a checkpoint of step 4 through ``AsyncCheckpointer``,
     written while steps 4-6 run, restored into a fresh state and
     compared with the state kept on the card, every tensor bit for bit;
     (e) step ms by CUDA events (median of steps 1-3, before the
     checkpoint; steps 4-6, beside its write, apart), tokens/s, peak
     memory, and by ``torch.profiler`` on step 7 the kernels' share of
     the device time, the shares of the two backward Functions'
     autograd nodes and the largest kernels, each beside the card's
     name and power limit;
  9. the main path, part six: the moe, audio and vlm families, random
     float32 weights from a seeded generator, cast to bf16 where used,
     each model built on the card: (a) whisper-small at full width and
     depth (12 encoder layers over 1,500 frames, padded to 1,536 and
     bounded by the kernel's ``kv_len``; 12 decoder layers): one prefill
     of ``TokenPipeline``'s audio (normal x 0.1) with the first encoder
     and the first cross-attention call captured, each held against
     ``attention_plain`` (the output at bf16's RTOL, each row's lse at
     float32's, which a lost key-length mask fails) and timed beside
     the plain version,
     SDPA over the 1,500 real keys and the bound; prefill of 255 tokens
     and one decode step against ``forward`` (0.05; 0.3 of the spread);
     then ``ServingEngine.generate`` of 4 requests of 256 tokens, 32 new
     each, max_len 448, with every launch counter set to 0 before and
     read after: exactly 36 flash-attention launches and no other; (b)
     whisper-small trained 8 steps (``TokenPipeline`` 4 x 448, remat
     full, AdamW as phase 8): at step 0's first cross-attention call's
     shapes ``_Flash`` against autograd through ``attention_plain``
     (output and gradients in float32 and bf16, each at its RTOL; bf16's
     dq against ``dq_same_algorithm``, whose delta reads the bf16
     output as the flash backward's does), every launch counter around step
     1 (exactly 60: 12 encoder, 24 decoder and 24 in the recompute), the
     loss finite and lower at the last step than at the first; (c)
     qwen2-vl-2b at full width and depth served as (a), 4 requests of
     1,024 tokens (zero patch embeddings, M-RoPE positions), its first
     attention call held against the plain version as (a), exactly 28
     launches;
     (d) qwen3-moe-235b-a22b at full width with its depth cut from 94 to
     4 layers (one layer's experts hold 9.66 GB in float32) served as
     (c), with ``moe_routing`` at each layer of a prefill (the share of
     (token, expert) choices dropped by capacity and what decides it),
     layer 0's MoE on one row held against the same module on the CPU in
     float32 (routes equal, output at float32's RTOL), exactly 4
     launches; each part's prefill
     ms and decode ms a token (CUDA events), tokens/s, peak memory and
     the kernel's share of a prefill (``torch.profiler``), beside the
     card's name and power limit;
 10. the main path, part seven: the free-running strategies
     (``engine_torch.free_run``: the GA, PSO, DE and random search, R =
     1024 runs x G = 100 generations x P = 20, one budget-scan launch a
     generation): (a) each on the synthetic GEMM cache (all 10,140
     configs) with a budget of 0.02 of its total charge, exactly G
     launches a call, the wall a call (median of 3, synchronised), fresh
     evaluations a second, the share of runs exhausted and the scan's
     share of the device time (``torch.profiler``), beside the card's
     name and power limit; (b) the same call again bit-identical; (c)
     the same call with ``budget_scan_plain`` patched in for the kernel
     bit-identical; (d) the invariants of tests/test_engine_jax.py
     (curves (R, G) and monotone, ending at the spend and best;
     ``spent_evals`` equal to ``fresh_evals``; the spend within the
     budget up to the one commit that may cross it; every finite best a
     valid row whose time it is); (e) each strategy's mean best within
     3x the spread of 25 runs of the numpy strategy on the same cache
     and budget; the kernel's device time at (R, P) beside its bound;
     (f) the GA, PSO and DE on phase 4's hotspot recording (1,104
     invalid configs of 6,144; the unrecorded rows charged the mean
     charge), a tenth of its charge, (d)'s invariants; (g) random search
     with no budget over the whole hotspot space (64 runs x 254
     generations): 5,040 fresh evaluations a run, the recording's
     optimum, the spend of every valid row (rtol 1e-10); (h) a call's
     host synchronisations (``torch.cuda.set_sync_debug_mode``) the same
     at G and at 2G;
 11. the main path, part eight: the FAIR hub, the ConfigHub lookup
     service and the scenario layer, on a fresh root under
     ``chiprun_out/`` (removed at the end): (a) ``Hub.build`` of the four
     hub kernels through the cost model on tpu_v5e and tpu_lite_b at
     their hub sizes (8 entries) plus flash attention's and the SSD's
     smoke recordings live on the card, every sha256 verified, the build's
     wall; flash attention and the SSD launched exactly as often as
     their recordings ran them (one warm-up and ``repeats`` launches an
     ok config), the hub kernels not at all; (b) ``run_fleet`` of the
     four hub kernels on the card's label, runner live, 32 evaluations
     of 3 repeats a scenario: both shapes (hub size and smoke) recorded
     through the hand-written kernels and registered, each kernel
     launched exactly as often as its recordings ran it; a second fleet
     records nothing (every scenario skipped); the coverage marks the 8
     scenarios recorded and the gate of the report against itself
     passes; (c) lookups: gemm on the card's label at the hub size
     exact, with ``disk_loads`` flat after the first hit; the median of
     10,000 warmed exact hits against the naive scan over the cache's
     results plus the config decode, on the card's entry and on
     gemm@tpu_v5e (10,140 configs), best configs equal; gemm at m=2048
     on the card a transfer from the 4096^3 entry; gemm on tpu_v4 at the
     hub size a cross-device transfer (confidence 2/3) and at 32768^3 a
     modeled answer equal to ``best_modeled``; one ``serve_requests``
     array line answering each request; (d) warm start on a second,
     empty root: dedispersion on the card's label answers ``warming``,
     the flight (live on the card, on its own thread) is joined and the
     same lookup answers ``exact``, dedispersion launched exactly as
     often as the flight's recording ran it; (e) ``Tuner(hub_root=root,
     device="cuda").simulate`` of the GA over the hub's train split (the
     four tpu_v5e entries) through the torch engine and the budget scan,
     bit-identical to the numpy engine, its budget-scan launches
     printed; (f) ``python -m repro_torch`` as subprocesses: ``hub
     verify`` exits 0, ``lookup`` of gemm on the card's label exits 0, a
     lookup with nothing recorded and nothing to model exits 3,
     ``scenarios --out`` then ``scenarios --gate`` exit 0;
 12. the mesh tooling: (a) a real one-rank process group (``nccl`` over
     a file store) and ``make_host_mesh()``: zamba2-1.2b at full width
     served (phase 7's 4 x 1024 prefill and ``MESH_DECODE_STEPS``
     decode steps) and its loss and gradients at phase 8's 4 x 1024,
     first with plain parameters, then with the same weights as DTensor
     parameters placed by ``param_shardings`` through ``annotate`` and
     the kernels' ``local_map`` call sites: logits, cache, loss and
     every gradient bit-identical, and the flash-attention and SSD
     launches equal; (b) the fake-world dry run (``run_cell``) of
     ``DRYRUN_CELLS`` at the published configs' full size on the
     ``single`` (256 ranks) and ``multi`` (512) meshes, in
     ``DRYRUN_WORKERS`` spawned processes each with its own fake world:
     every cell ``ok``, its dominant term, useful ratio, peak GiB a rank,
     collectives by type and trace seconds; (c) ``hillclimb`` of
     olmo-1b train_4k on the single mesh, 6 evaluations, the card's
     memory as the budget, in the same pool: its improvement over the
     baseline.

Before phase 5 every recording is checked to let a tuning run end
(``ends_check``); phases 5, 6, 7, 8, 9, 10 and 11 each fail past a
wall-clock limit (12 too).
The budget-scan launches of phases 5-6 are printed by strategy and
campaign.

Kernel launch counters are set to 0 just before phase 4 and read just
after phase 6, again just before phase 7's (d) and read just after it,
again around phase 8's step 1, and around each main path of phase 9
(each generate, whisper's step 1), again just before phase 10 and read
just after it, and around each of phase 11's (a), (b), (d) and (e);
each kernel must have launched in phases 4-6, flash attention and the
SSD exactly once an attention site and a Mamba layer in phase 7's (d),
6 and 76 times in phase 8's step, flash attention alone 36, 60, 28 and
4 times in phase 9, the budget scan alone in phase 10, exactly once a
generation of each ``free_run`` call, and in phase 11 each kernel
exactly as often as its live recordings ran it (the budget scan alone
in (e)), again around phase 12 (a), whose sharded calls launch exactly
as the plain ones (the dry run launches nothing: its tensors are
fakes). The line
before the last is the JSON summary of every kernel, its launches those
of the main paths; the last line is the device record ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import pathlib
import random
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): what each kernel's bound uses
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12       # float32 outside the tensor cores (an FMA is 2)
PEAK_F32_ADDS = 33.5e12      # float32 adds a second (one per lane a clock)
PEAK_F64_FLOPS = 34e12       # float64 outside the tensor cores
PEAK_BYTES = 3.35e12
SMEM_WORDS = 132 * 32 * 1.98e9  # shared memory: 32 words a clock an SM
RTOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}  # tests/test_kernels.py
HUB = 4096
# tests/test_kernels.py's shapes and tolerances of the other hub kernels
# (h, w, fh, fw, strip_h, block_w): tests/test_kernels.py's shapes (one
# 130 wide: 4-byte copies), then a filter width the kernel reads at run time
CONV_SHAPES = [(64, 128, 5, 5, 32, 128), (96, 130, 3, 7, 48, 96),
               (128, 256, 17, 17, 16, 128), (128, 256, 33, 33, 16, 128)]
# the hub tiling (timed in the JSON row), a non-dividing one, one sub-tile
# a tile, the smallest tile and the largest (8 blocks)
CONV_HUB_TILINGS = [(64, 256), (48, 320), (24, 256), (8, 96), (512, 4096)]
HOT_TOL, CONV_TOL, DEDISP_TOL = 1e-4, 1e-3, 1e-4
# (strip_h, block_w, t_block) at the hub size: the hub tiling at t_block 4
# (timed in the JSON row), 1 and 16, the smallest tile (one run of 16 rows
# a thread), 52 sub-tiles a tile, and the largest tile (4 blocks)
HOT_HUB_CASES = [(64, 512, 4), (64, 512, 1), (64, 512, 16), (8, 128, 3),
                 (256, 1024, 8), (1024, 4096, 16)]
DEDISP_TILINGS = [(8, 256), (4, 192), (16, 128)]
# the hub tiling (timed in the JSON row), a non-dividing one, the smallest
# tile, a T=2 plan and the largest tile
DEDISP_HUB_TILINGS = [(32, 512), (12, 384), (1, 128), (4, 192), (128, 3968)]
DEDISP_ADVERSARIAL = [(32, 512), (1, 128)]    # hub tilings, adversarial
GEMM_SHAPES = [  # (m, n, k, block_m, block_n, block_k)
    (128, 128, 128, 64, 128, 128),
    (192, 256, 320, 96, 128, 64),
    (200, 130, 90, 64, 128, 128),
]
HUB_TILINGS = [(128, 128, 64), (96, 160, 48)]  # aligned, irregular
# bf16 plan classes at the hub size (kernels/gemm.py, ``plan``): two wgmma
# pieces of 256, a 16-row tile padded to 64, one stage, two consumers of
# 64 x 256 (the widest accumulator); then an unaligned shape near the hub
# size, which the wrapper pads to multiples of 8
HUB_CLASS_TILINGS = [(64, 512, 64), (16, 256, 128), (128, 128, 384),
                     (128, 256, 64)]
HUB_UNALIGNED = (HUB - 1, HUB - 3, HUB - 6)
SASS_NEEDED = ("HGMMA", "UTMALDG")  # wgmma and TMA loads in the GEMM's SASS
SCAN_RUNS = 1024
REPEATS = 25
# the live recordings' budgets: fresh evaluations, and measured seconds as
# a cap (a few tilings take tens of ms a launch). Sizes are the hub's;
# the framework kernels' sizes are full model widths: starcoder2-7b's
# attention (src/repro/configs/starcoder2_7b.py: 36 q heads over 4 kv heads,
# d_head 128) on one 4096-token sequence, and mamba2-130m's SSD
# (src/repro/configs/mamba2_130m.py: 24 heads, head dim 64, state 128) over
# 8 sequences of 4096, the reference workload()'s own default.
HUB_PROBLEMS = {
    "gemm": {"m": HUB, "n": HUB, "k": HUB},
    "convolution": {"h": HUB, "w": HUB, "fh": 17, "fw": 17},
    "hotspot": {"h": HUB, "w": HUB},
    "dedispersion": {"nchan": 256, "ntime": 16384, "ndm": 256},
    "flash_attention": {"bh": 36, "bh_kv": 4, "seq": 4096, "d": 128},
    "ssd": {"bh": 24 * 8, "seq": 4096, "p": 64, "n": 128},
}
RECORD_EVALS = {"gemm": 512, "convolution": 1024, "hotspot": 1024,
                "dedispersion": 1024, "flash_attention": 50, "ssd": 30}
RECORD_SECONDS = {"gemm": 150.0, "convolution": 60.0, "hotspot": 60.0,
                  "dedispersion": 60.0, "flash_attention": 60.0,
                  "ssd": 60.0}
# (block_q, block_kv) at full width: the JSON row's tiling, the narrow
# block's, a middle one and the largest; and chunk: a small one, the largest
ATTN_TILINGS = [(128, 128), (64, 128), (256, 512), (1024, 2048)]
# gemma3-1b's attention (src/repro/configs/gemma3_1b.py: 4 q heads over 1
# kv head, d_head 256, local layers' window 512) on one 4096-token sequence
ATTN_WIDE_HEADS = {"bh": 4, "bh_kv": 1, "seq": 4096, "d": 256}
ATTN_WIDE_WINDOWS = (None, 512)
# chunk: the JSON row's, the recording's best (PR 20), the largest
SSD_CHUNKS = (128, 64, 512)
# the GA's populations of the Table III grid (10, 20, 30), padded as the
# replay engine pads a batch: the segments phase 6 sends at R = 1
SCAN_R1_LENGTHS = (16, 32)
COMMIT_BATCHES = 300         # commit_rows calls timed at each length
SSD_TOL = 3e-3               # tests/test_kernels.py
STRATEGIES = ("random_search", "genetic_algorithm", "simulated_annealing",
              "pso", "dual_annealing", "differential_evolution",
              "basin_hopping", "greedy_ils", "mls")  # phase 5, all nine
FUSED_CHECK = ("random_search", "genetic_algorithm", "pso",
               "differential_evolution")  # fused drives checked in phase 5
GUARD_ASKS = 100_000         # asks in a row with no fresh config: endless
SCORE_LIMIT_S = 300          # phase 5 fails past this wall-clock limit
HYPERTUNE_REPEATS = 3        # the paper's 25, cut to fit the time limit
HYPERTUNE_LIMIT_S = 300      # phase 6 fails past this wall-clock limit
META_EVALS = 50              # phase 6's meta campaign: GA configs scored
# phase 7: zamba2-1.2b (src/repro_torch/configs/zamba2_1_2b.py) at full
# width, 38 Mamba2 layers and 6 shared-attention calls a prefill
SERVE_ARCH = "zamba2-1.2b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, SERVE_MAX_LEN = 4, 1024, 32, 2048
SERVE_LIMIT_S = 180          # phase 7 fails past this wall-clock limit
PROFILE_TOP = 12             # kernels listed by device time (prefill, step)
# phase 8: training zamba2-1.2b at full width (6 shared-attention calls
# and 38 Mamba2 layers a forward; remat full recomputes the Mamba layers)
TRAIN_ARCH = "zamba2-1.2b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_SAVE_AT = 4, 1024, 8, 4
TRAIN_LIMIT_S = 240          # phase 8 fails past this wall-clock limit
# phase 9: whisper-small (configs/whisper_small.py) at full width and
# depth, served (12 encoder calls over 1,500 frames, 12 self- and 12
# cross-attention calls a prefill) and trained (remat full: 60 calls a
# step); qwen2-vl-2b served (28 a prefill); qwen3-moe-235b-a22b served at
# full width with its depth cut to 4 layers (one layer's experts hold 9.66
# GB in float32: 94 do not fit one card)
WHISPER_ARCH, VLM_ARCH, MOE_ARCH = ("whisper-small", "qwen2-vl-2b",
                                    "qwen3-moe-235b-a22b")
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_NEW = 4, 256, 32
WHISPER_MAX_LEN = 448        # whisper's decoder context
WHISPER_TRAIN_SEQ, WHISPER_STEPS = 448, 8
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_NEW, FAMILY_MAX_LEN = 4, 1024, 32, 2048
MOE_LAYERS = 4
FAMILY_LIMIT_S = 240         # phase 9 fails past this wall-clock limit
# phase 10: free-running strategies (free_run) at the reference's maxiter
# and popsize defaults, over phase 3's run count
FREE_STRATEGIES = ("genetic_algorithm", "pso", "differential_evolution",
                   "random_search")
FREE_RUNS, FREE_GENERATIONS, FREE_POP = SCAN_RUNS, 100, 20
# budgets, as shares of each cache's total charge: on the whole GEMM
# cache 0.02 (about 200 configs' charge) ends most runs mid-campaign, so
# the freeze runs; a tenth leaves the GA's runs unspent after 100
# generations (about 400 fresh configs a run). On the partial hotspot
# recording a tenth (about 100 evaluations, misses charged the mean)
FREE_BUDGET_SHARE = 0.02
HOT_BUDGET_SHARE = 0.1
FREE_EXHAUST_RUNS = 64       # (g): random search over the whole space
FREE_RUN_LIMIT_S = 120       # phase 10 fails past this wall-clock limit
# phase 11: the hub, the lookup service and the scenario layer
HUB_LIMIT_S = 300            # phase 11 fails past this wall-clock limit
HUB_MODELS = ("tpu_v5e", "tpu_lite_b")  # device models of (a)'s build
FLEET_EVALS, FLEET_REPEATS = 32, 3
WARM_EVALS = 16
LOOKUP_HITS = 10_000         # warmed exact hits timed in (c)
NAIVE_SCANS = {"card": 1000, "tpu_v5e": 100}  # naive scans timed in (c)
FAR_GEMM = {"m": 32768, "n": 32768, "k": 32768}  # no donor within 0.3
HUB_SCORE_REPEATS = 25       # (e): the paper's repeats
# phase 12: the mesh tooling. (a) zamba2-1.2b on a one-rank mesh at phase
# 7's and phase 8's shapes; (b) one dry-run cell a family and kind at the
# published configs' full size, both meshes; (c) the distribution
# hillclimb
MESH_DECODE_STEPS = 3
DRYRUN_CELLS = (("olmo-1b", "train_4k"), ("grok-1-314b", "train_4k"),
                ("whisper-small", "train_4k"), ("zamba2-1.2b", "prefill_32k"),
                ("qwen2-vl-2b", "prefill_32k"),
                ("qwen3-moe-235b-a22b", "decode_32k"),
                ("mamba2-130m", "decode_32k"), ("gemma3-1b", "long_500k"))
DRYRUN_WORKERS = 4           # processes tracing cells at once (8 cores)
HILLCLIMB = ("olmo-1b", "train_4k", "single", 6)
MESH_LIMIT_S = 600           # phase 12 fails past this wall-clock limit


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


def spread_ms(fn, reps: int = 7, warmup: int = 1) -> tuple:
    """``(median, min, max, host median)`` over ``reps`` CUDA-event timings
    of one ``fn()`` each; host is the wall until ``fn`` returns, before the
    card finishes. A host median near the event median says the host's
    launches, not the card, set the time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times, host = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return (statistics.median(times), min(times), max(times),
            statistics.median(host))


def kernel_device_ms(fn, kernel: str, reps: int = 50):
    """Mean device time in ms of the CUDA kernel whose name holds
    ``kernel`` over ``reps`` calls of ``fn``, from ``torch.profiler``'s
    CUDA activity; None where the trace holds no such kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        if kernel in evt.key and evt.count:
            return evt.device_time_total / evt.count / 1e3
    return None


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ----------------------------------------------------------------- phase 2
def check_instantiations(what: str, log: str, pattern: str, want: set,
                         label) -> None:
    """Print the registers and spills of each instantiation of a templated
    kernel from ptxas' ``-v`` report in ``log`` (``pattern`` matches its
    mangled name and captures the template arguments, or the kernel's name
    and its arguments; a group that did not take part is dropped; ``label``
    formats them, a format string or a function); fail on a spill or on
    instantiations other than ``want``."""
    rows, current = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            kern = re.search(pattern, entry.group(1))
            current = tuple(int(g) if g.isdigit() else g
                            for g in kern.groups()
                            if g is not None) if kern else None
        elif current is not None:
            for key, pat in (("stores", r"(\d+) bytes spill stores"),
                             ("loads", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers")):
                found = re.search(pat, line)
                if found:
                    rows.setdefault(current, {})[key] = int(found.group(1))
    for args, row in sorted(rows.items(), key=str):
        name = label(*args) if callable(label) else label.format(*args)
        print(f"  {what} {name}: {row.get('registers')} "
              f"registers, spill stores {row.get('stores')} B, loads "
              f"{row.get('loads')} B")
    if set(rows) != want:
        fail(f"ptxas reported {what} instantiations {sorted(rows)}, not "
             f"{sorted(want)}")
    spilled = [k for k, row in rows.items()
               if row.get("stores", 1) or row.get("loads", 1)]
    if spilled:
        fail(f"{what} instantiations {spilled} spill registers")


def check_dedisp_build(log: str) -> None:
    """Registers and spills of each (G, T) instantiation of the
    dedispersion kernel; a spill fails."""
    from repro_torch.kernels import dedispersion as dd
    check_instantiations(
        "dedispersion", log, r"dedisp_kernelILi(\d+)ELi(\d+)E",
        {(g, t) for g in dd.DMS_PER_THREAD for t in dd.SAMPLES_PER_THREAD},
        "G {} T {}")


def check_conv_build(log: str) -> None:
    """Registers and spills of each (filter width, R) instantiation of the
    convolution kernel (width 0: read at run time); a spill fails."""
    from repro_torch.kernels import convolution as cv
    check_instantiations(
        "convolution", log, r"conv2d_kernelILi(\d+)ELi(\d+)E",
        set(cv.INSTANTIATIONS.items()), "fw {} R {}")


def check_hotspot_build(log: str) -> None:
    """Registers and spills of each R instantiation of the hotspot kernel;
    a spill fails."""
    from repro_torch.kernels import hotspot as hs
    check_instantiations("hotspot", log, r"hotspot_kernelILi(\d+)E",
                         {(hs.ROWS,)}, "R {}")


def check_attention_build(log: str) -> None:
    """Registers and spills of each (bf16, d_max, threads, sub_kv)
    instantiation of the flash-attention kernel; a spill fails."""
    from repro_torch.kernels import flash_attention as fa
    check_instantiations(
        "flash_attention", log,
        r"attn_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E",
        set(fa.INSTANTIATIONS), "bf16 {} D {} threads {} sub_kv {}")


def check_ssd_build(log: str) -> None:
    """Registers and spills of the SSD's three kernels (the state pass in
    its float and float4 forms); a spill fails."""
    check_instantiations(
        "ssd", log, r"(ssd_chunk_states|ssd_state_pass|ssd_chunk_outputs)"
        r"(?:ILi(\d+)E)?", {("ssd_chunk_states",), ("ssd_state_pass", 1),
                            ("ssd_state_pass", 4), ("ssd_chunk_outputs",)},
        lambda name, *v: name + "".join(f"<{x}>" for x in v))


def check_sass(lib: pathlib.Path) -> None:
    """Fail unless the GEMM library's SASS holds wgmma (``HGMMA``) and TMA
    loads (``UTMALDG``): the bf16 path runs on the tensor cores, fed by
    TMA."""
    from repro_torch import cuda
    sass = subprocess.run([cuda.toolkit("cuobjdump"), "--dump-sass", str(lib)],
                          capture_output=True, text=True, timeout=120)
    if sass.returncode:
        fail(f"cuobjdump failed on {lib.name}: {sass.stderr.strip()}")
    counts = {op: sass.stdout.count(op) for op in SASS_NEEDED}
    print(f"  gemm SASS: {counts}")
    missing = [op for op, count in counts.items() if not count]
    if missing:
        fail(f"the GEMM library's SASS lacks {missing}")


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


def kernel_row(name: str, source: str, replaces: str, err: float, ms: float,
               plain_ms: float, ops_ms: float, bytes_ms: float,
               library_ms) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": library_ms}


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
    cases += [(hub, hub, hub, t, torch.bfloat16)
              for t in HUB_TILINGS + HUB_CLASS_TILINGS]
    cases.append((*HUB_UNALIGNED, HUB_TILINGS[0], torch.bfloat16))
    hub_err = 0.0
    for m, n, k, (bm, bn, bk), dtype in cases:
        pl = gm.plan({"block_m": bm, "block_n": bn, "block_k": bk}, m, n, k,
                     dtype)
        print(f"  plan {str(dtype)[6:]} {m}x{n}x{k} ({bm},{bn},{bk}): "
              + (f"wgmma N {pl.wgmma_n} x {pl.pieces}, consumers "
                 f"{pl.warpgroups} x {pl.frags} frags, stages {pl.stages}, "
                 f"swizzle A {pl.swizzle_a} B {pl.swizzle_b}, "
                 f"padded {pl.padded}" if pl.path == "wgmma" else
                 f"fma, {pl.threads} threads"))
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
        if m >= hub - 8:
            hub_err = max(hub_err, err)
    a, b, c0 = operands(hub, hub, hub, torch.bfloat16)
    flops = 2.0 * hub ** 3 + 3.0 * hub * hub
    times = {t: time_ms(lambda: gm.gemm(a, b, c0, block_m=t[0], block_n=t[1],
                                        block_k=t[2], alpha=0.5, beta=1.5))
             for t in HUB_TILINGS + HUB_CLASS_TILINGS}
    for t, t_ms in times.items():
        print(f"  gemm {hub}^3 bf16 {t}: kernel {t_ms:.4f} ms "
              f"({flops / t_ms / 1e9:.1f} TFLOP/s)")
    bm, bn, bk = HUB_TILINGS[0]
    ms = times[HUB_TILINGS[0]]
    plain_ms = time_ms(lambda: gm.gemm_plain(a, b, c0, alpha=0.5, beta=1.5))
    # yardstick only: one PyTorch call computing the same function
    library_ms = time_ms(lambda: torch.addmm(c0, a, b, beta=1.5, alpha=0.5))
    moved = nbytes(a, b, c0) + hub * hub * 2
    ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, moved / PEAK_BYTES * 1e3
    print(f"  gemm {hub}^3 bf16 ({bm},{bn},{bk}): kernel {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
          f"torch.addmm {library_ms:.4f} ms, bound {max(ops_ms, bytes_ms):.4f}"
          f" ms (operations {ops_ms:.4f}, bytes {bytes_ms:.4f})")
    return kernel_row("gemm", "src/repro_torch/kernels/csrc/gemm.cu",
                      "src/repro/kernels/gemm.py:40", hub_err, ms, plain_ms,
                      ops_ms, bytes_ms, library_ms)


def agree(what: str, out: torch.Tensor, ref: torch.Tensor,
          tol: float) -> float:
    """Max |err| of a kernel's output against its plain version's; fails
    past tests/test_kernels.py's ``rtol = atol = tol``."""
    if out.shape != ref.shape:
        fail(f"{what}: shape {tuple(out.shape)} against the plain version's "
             f"{tuple(ref.shape)}")
    err = (out - ref).abs().max().item()
    ok = bool(torch.isfinite(out).all()) and torch.allclose(
        out, ref, rtol=tol, atol=tol)
    print(f"  {what}: max |err| {err:.6g}"
          f"{' (bit-identical)' if torch.equal(out, ref) else ''} "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{what} disagrees with its plain version")
    return err


def randn(rng, shape, device, scale: float = 1.0) -> torch.Tensor:
    x = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
    return torch.from_numpy(x).to(device)


def exact(what: str, out: torch.Tensor, ref: torch.Tensor, tol: float,
          plain: str) -> float:
    """``agree`` within ``tol``, and fail unless bit-identical: the kernel
    computes in the plain version's order, without contraction."""
    err = agree(what, out, ref, tol)
    if not torch.equal(out, ref):
        fail(f"{what} is not bit-identical to {plain}")
    return err


def check_conv(device: str) -> dict:
    """Convolution kernel vs ``conv2d_plain``, bit for bit, at the test
    shapes (one of them 130 wide, one a run-time filter width) and at the
    hub size at every tiling of CONV_HUB_TILINGS, each with its launch plan
    printed and timed; the JSON row at the first."""
    from repro_torch.kernels import convolution as cv
    rng = np.random.default_rng(1)
    for h, w, fh, fw, sh, bw in CONV_SHAPES:
        x, f = randn(rng, (h, w), device), randn(rng, (fh, fw), device)
        exact(f"convolution {h}x{w} filter {fh}x{fw} tiles ({sh},{bw})",
              cv.conv2d(x, f, strip_h=sh, block_w=bw), cv.conv2d_plain(x, f),
              CONV_TOL, "conv2d_plain")
    x, f = randn(rng, (HUB, HUB), device), randn(rng, (17, 17), device)
    ref = cv.conv2d_plain(x, f)
    flops = 2.0 * HUB * HUB * 17 * 17
    hub_err, times = 0.0, {}
    for sh, bw in CONV_HUB_TILINGS:
        pl = cv.plan(sh, bw, 17, 17)
        print(f"  plan ({sh},{bw}): {pl.instantiation}, C {pl.cols}, "
              f"threads {pl.threads_x} x {pl.threads_y} ({pl.threads}), "
              f"sub-tile {pl.sub_h} x {pl.sub_w} "
              f"({pl.sub_tiles(sh, bw)} a tile), {pl.stages} stages, pitch "
              f"{pl.pitch}, {pl.shared_bytes} B shared")
        hub_err = max(hub_err, exact(
            f"convolution {HUB}x{HUB} filter 17x17 tiles ({sh},{bw})",
            cv.conv2d(x, f, strip_h=sh, block_w=bw), ref, CONV_TOL,
            "conv2d_plain"))
        times[sh, bw] = time_ms(lambda: cv.conv2d(x, f, strip_h=sh,
                                                  block_w=bw))
        print(f"  convolution hub ({sh},{bw}): kernel {times[sh, bw]:.4f} ms "
              f"({flops / times[sh, bw] / 1e9:.2f} TFLOP/s)")
    sh, bw = CONV_HUB_TILINGS[0]
    ms = times[sh, bw]
    plain_ms = time_ms(lambda: cv.conv2d_plain(x, f))
    # yardstick only: one PyTorch call computing the same function (cuDNN,
    # TF32 off as main() sets it)
    library_ms = time_ms(lambda: torch.nn.functional.conv2d(
        x[None, None], f[None, None], padding=8))
    ops_ms = flops / PEAK_F32_FLOPS * 1e3
    bytes_ms = (nbytes(x, f) + HUB * HUB * 4) / PEAK_BYTES * 1e3
    # a multiply and an add, each one instruction, at one a lane a clock
    floor_ms = flops / PEAK_F32_ADDS * 1e3
    print(f"  convolution {HUB}^2 17x17 ({sh},{bw}): kernel {ms:.4f} ms "
          f"({flops / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.4f} ms, "
          f"F.conv2d {library_ms:.4f} ms, bound {max(ops_ms, bytes_ms):.4f} "
          f"ms (operations {ops_ms:.4f}, bytes {bytes_ms:.4f}), "
          f"no-contraction floor {floor_ms:.4f} ms (__fmul_rn and __fadd_rn "
          f"at {PEAK_F32_ADDS / 1e12:.1f} T instructions a second)")
    return kernel_row("convolution", "src/repro_torch/kernels/csrc/"
                      "convolution.cu", "src/repro/kernels/convolution.py:40",
                      hub_err, ms, plain_ms, ops_ms, bytes_ms, library_ms)


def check_hotspot(device: str) -> dict:
    """Hotspot kernel vs ``hotspot_plain``, bit for bit, at the test shape
    (t_block 1, 2, 4) and at the hub size at every case of HOT_HUB_CASES,
    each with its launch plan printed and timed beside the bytes bound and
    the on-chip floor; the JSON row at the first."""
    from repro_torch.kernels import hotspot as hs
    rng = np.random.default_rng(3)
    t, p = randn(rng, (64, 128), device), randn(rng, (64, 128), device, 0.1)
    for tb in (1, 2, 4):
        exact(f"hotspot 64x128 tiles (32,128) t_block {tb}",
              hs.hotspot(t, p, strip_h=32, block_w=128, t_block=tb),
              hs.hotspot_plain(t, p, t_block=tb), HOT_TOL, "hotspot_plain")
    t, p = randn(rng, (HUB, HUB), device), randn(rng, (HUB, HUB), device, 0.1)
    bytes_ms = (nbytes(t, p) + HUB * HUB * 4) / PEAK_BYTES * 1e3
    row = None
    for sh, bw, tb in HOT_HUB_CASES:
        pl = hs.plan(sh, bw, tb)
        n_tiles = (HUB // sh) * (HUB // bw)
        cells, words = (n_tiles * x for x in pl.work(sh, bw))
        print(f"  plan ({sh},{bw},{tb}): {pl.instantiation}, threads "
              f"{pl.threads_x} x {pl.threads_y} ({pl.threads}), sub-tile "
              f"{pl.sub_h} x {pl.sub_w} ({pl.sub_tiles(sh, bw)} a tile, "
              f"{n_tiles} tiles), pitch {pl.pitch}, {pl.shared_bytes} B "
              f"shared; {cells} cell-steps ({cells / (HUB * HUB * tb):.3f}x "
              f"the grid's), {words} shared words")
        err = exact(f"hotspot {HUB}^2 tiles ({sh},{bw}) t_block {tb}",
                    hs.hotspot(t, p, strip_h=sh, block_w=bw, t_block=tb),
                    hs.hotspot_plain(t, p, t_block=tb), HOT_TOL,
                    "hotspot_plain")
        ms = time_ms(lambda: hs.hotspot(t, p, strip_h=sh, block_w=bw,
                                        t_block=tb))
        ops_ms = 8.0 * HUB * HUB * tb / PEAK_F32_FLOPS * 1e3
        # on chip: 8 float32 instructions a cell-step of the pyramid, and
        # its shared-memory words at 32 a clock an SM
        f32_ms = 8.0 * cells / PEAK_F32_ADDS * 1e3
        smem_ms = words / SMEM_WORDS * 1e3
        floor_ms = max(bytes_ms, f32_ms, smem_ms)
        print(f"  hotspot {HUB}^2 ({sh},{bw}) t_block {tb}: kernel "
              f"{ms:.4f} ms, bound {max(ops_ms, bytes_ms):.4f} ms "
              f"(operations {ops_ms:.4f}, bytes {bytes_ms:.4f}), on-chip "
              f"floor {floor_ms:.4f} ms (float32 {f32_ms:.4f}, shared "
              f"memory {smem_ms:.4f}), {ms / floor_ms:.2f}x the floor")
        if row is None:
            plain_ms = time_ms(lambda: hs.hotspot_plain(t, p, t_block=tb))
            print(f"  hotspot plain ({sh},{bw}) t_block {tb}: "
                  f"{plain_ms:.4f} ms")
            row = kernel_row("hotspot", "src/repro_torch/kernels/csrc/"
                             "hotspot.cu", "src/repro/kernels/hotspot.py:49",
                             err, ms, plain_ms, ops_ms, bytes_ms, None)
    return row


def adversarial_delays(rng, nchan: int, ndm: int, device: str):
    """A delay table not monotonic in dm, with values below 0 and above
    MAX_DELAY that the kernel clamps."""
    return torch.from_numpy(rng.integers(-100, 700, (nchan, ndm))
                            .astype(np.int32)).to(device)


def check_dedisp(device: str) -> dict:
    """Dedispersion kernel vs ``dedisperse_plain``, bit for bit, at the test
    shape and at the hub size; each hub tiling's plan printed and timed,
    the JSON row at the first."""
    from repro_torch.kernels import dedispersion as dd
    rng = np.random.default_rng(5)
    nchan, ntime, ndm = 32, 768 + dd.MAX_DELAY, 24
    x = randn(rng, (nchan, ntime), device)
    delays = dd.make_delays(nchan, ndm, device=device)
    adversarial = adversarial_delays(rng, nchan, ndm, device)
    x_odd = randn(rng, (nchan, ntime + 1), device)  # 4-byte copies
    for bdm, bt in DEDISP_TILINGS:
        for what, xs, ds in (("", x, delays),
                             (" adversarial delays", x, adversarial),
                             (" ntime+1", x_odd, delays)):
            exact(f"dedispersion {nchan}x{xs.shape[1]} {ndm} dms "
                  f"tiles ({bdm},{bt}){what}",
                  dd.dedisperse(xs, ds, block_dm=bdm, block_t=bt),
                  dd.dedisperse_plain(xs, ds), DEDISP_TOL,
                  "dedisperse_plain")
    hub = HUB_PROBLEMS["dedispersion"]
    nchan, ntime, ndm = hub["nchan"], hub["ntime"], hub["ndm"]
    x = randn(rng, (nchan, ntime), device)
    delays = dd.make_delays(nchan, ndm, device=device)
    ref = dd.dedisperse_plain(x, delays)
    adds = float(nchan * ndm * (ntime - dd.MAX_DELAY))
    hub_err, times = 0.0, {}
    for bdm, bt in DEDISP_HUB_TILINGS:
        pl = dd.plan(bdm, bt, nchan, ndm)
        print(f"  plan ({bdm},{bt}): G {pl.dms_per_thread} x T "
              f"{pl.samples_per_thread}, warps {pl.warps_dm} x {pl.warps_t} "
              f"({pl.threads} threads), sub-tile {pl.group} dms x "
              f"{pl.sub_t} samples, {pl.stages} stages of up to {pl.chans} "
              f"channels ({pl.stage_floats} floats), {pl.shared_bytes} B "
              f"shared")
        hub_err = max(hub_err, exact(
            f"dedispersion {nchan}x{ntime} {ndm} dms tiles ({bdm},{bt})",
            dd.dedisperse(x, delays, block_dm=bdm, block_t=bt), ref,
            DEDISP_TOL, "dedisperse_plain"))
        times[bdm, bt] = time_ms(lambda: dd.dedisperse(
            x, delays, block_dm=bdm, block_t=bt))
        print(f"  dedispersion hub ({bdm},{bt}): kernel "
              f"{times[bdm, bt]:.4f} ms ({adds / times[bdm, bt] / 1e9:.2f} "
              f"T adds/s)")
    adversarial = adversarial_delays(rng, nchan, ndm, device)
    ref_adv = dd.dedisperse_plain(x, adversarial)
    for bdm, bt in DEDISP_ADVERSARIAL:
        exact(f"dedispersion {nchan}x{ntime} {ndm} dms tiles "
              f"({bdm},{bt}) adversarial delays",
              dd.dedisperse(x, adversarial, block_dm=bdm, block_t=bt),
              ref_adv, DEDISP_TOL, "dedisperse_plain")
    bdm, bt = DEDISP_HUB_TILINGS[0]
    ms = times[bdm, bt]
    plain_ms = time_ms(lambda: dd.dedisperse_plain(x, delays))
    ops_ms = adds / PEAK_F32_ADDS * 1e3
    bytes_ms = nbytes(x, delays, ref) / PEAK_BYTES * 1e3
    floor_ms = adds / SMEM_WORDS * 1e3
    print(f"  dedispersion hub ({bdm},{bt}): kernel {ms:.4f} ms "
          f"({adds / ms / 1e9:.2f} T adds/s), plain {plain_ms:.4f} ms, "
          f"bound {max(ops_ms, bytes_ms):.4f} ms (operations {ops_ms:.4f}, "
          f"bytes {bytes_ms:.4f}), shared-memory floor {floor_ms:.4f} ms "
          f"(one word an add at 32 words a clock an SM)")
    return kernel_row("dedispersion", "src/repro_torch/kernels/csrc/"
                      "dedispersion.cu", "src/repro/kernels/dedispersion.py:50",
                      hub_err, ms, plain_ms, ops_ms, bytes_ms, None)


def check_attention(device: str) -> dict:
    """Flash-attention kernel vs ``attention_plain`` at tests/test_kernels.py's
    shapes, then at starcoder2-7b's width at every tiling of ATTN_TILINGS,
    each with its launch plan printed and timed; the JSON row at the
    first, with SDPA (float32, TF32 off) as the yardstick."""
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(6)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (randn(rng, s, device).to(dtype)
                   for s in ((4, 256, 64), (2, 256, 64), (2, 256, 64)))
        for causal, window in ((True, None), (False, None), (True, 64)):
            agree(f"flash_attention 4x256x64 over 2 kv heads "
                  f"{str(dtype)[6:]} causal {causal} window {window} tiles "
                  f"(128,128)",
                  fa.flash_attention(q, k, v, block_q=128, block_kv=128,
                                     causal=causal, window=window).float(),
                  fa.attention_plain(q, k, v, causal=causal,
                                     window=window).float(), RTOL[dtype])
    p = HUB_PROBLEMS["flash_attention"]
    bh, bh_kv, s, d = p["bh"], p["bh_kv"], p["seq"], p["d"]
    q = randn(rng, (bh, s, d), device)
    k, v = randn(rng, (bh_kv, s, d), device), randn(rng, (bh_kv, s, d), device)
    ref = fa.attention_plain(q, k, v, causal=True)
    flops = 4.0 * bh * s * s * d * 0.5
    err, times = 0.0, {}
    for bq, bkv in ATTN_TILINGS:
        pl = fa.plan(bq, bkv, s, d)
        print(f"  plan ({bq},{bkv}): {pl.instantiation}, {pl.groups} row "
              f"groups of {pl.rows} rows, q sub-tile {pl.sub_q} "
              f"({pl.q_sub_tiles(bq)} a tile), kv sub-tile {pl.sub_kv}, "
              f"pitch {pl.pitch}, {bh * (s // bq)} blocks")
        err = max(err, agree(
            f"flash_attention {bh}x{s}x{d} over {bh_kv} kv heads causal "
            f"tiles ({bq},{bkv})",
            fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv), ref,
            RTOL[torch.float32]))
        times[bq, bkv] = time_ms(lambda: fa.flash_attention(
            q, k, v, block_q=bq, block_kv=bkv))
        print(f"  flash_attention {bh}x{s}x{d} causal ({bq},{bkv}): kernel "
              f"{times[bq, bkv]:.4f} ms "
              f"({flops / times[bq, bkv] / 1e9:.2f} TFLOP/s)")
    del ref
    ops_ms = flops / PEAK_F32_FLOPS * 1e3
    bytes_ms = (nbytes(q, k, v) + q.numel() * 4) / PEAK_BYTES * 1e3
    plain_ms = time_ms(lambda: fa.attention_plain(q, k, v, causal=True),
                       reps=3, warmup=1)
    # yardstick only: one PyTorch call computing the same function
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(q[None], k[None], v[None],
                                      is_causal=True, enable_gqa=True))
    print(f"  flash_attention plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} "
          f"ms, bound {max(ops_ms, bytes_ms):.4f} ms (operations "
          f"{ops_ms:.4f}, bytes {bytes_ms:.4f})")
    check_attention_wide_heads(device, rng)
    return kernel_row("flash_attention", "src/repro_torch/kernels/csrc/"
                      "flash_attention.cu",
                      "src/repro/kernels/flash_attention.py:39", err,
                      times[ATTN_TILINGS[0]], plain_ms, ops_ms, bytes_ms,
                      library_ms)


def ssd_pass_ms(args, chunk: int, reps: int = 10) -> list:
    """Median time of each of the SSD's three kernels over ``reps`` calls,
    by CUDA events recorded before the first kernel and after each."""
    from repro_torch.kernels import ssd
    ssd.ssd_scan(*args, chunk=chunk)
    times = []
    for _ in range(reps):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ssd.ssd_scan(*args, chunk=chunk, marks=marks)
        marks[-1].synchronize()
        times.append([marks[i].elapsed_time(marks[i + 1]) for i in range(3)])
    return [statistics.median(t[i] for t in times) for i in range(3)]


def check_attention_wide_heads(device: str, rng) -> None:
    """The d_max 256 instantiations against ``attention_plain``: at a small
    size in float32 and bf16 (causal, window, GQA), then at gemma3-1b's
    width (ATTN_WIDE_HEADS), causal and with its local layers' window, each
    with its plan printed and timed beside its operations bound."""
    from repro_torch.kernels import flash_attention as fa
    for dtype in (torch.float32, torch.bfloat16):
        q = randn(rng, (6, 512, 256), device).to(dtype)
        k, v = (randn(rng, (2, 512, 256), device).to(dtype)
                for _ in range(2))
        for causal, window in ((True, None), (False, None), (True, 64)):
            agree(f"flash_attention 6x512x256 over 2 kv heads "
                  f"{str(dtype)[6:]} causal {causal} window {window} tiles "
                  f"(128,128)",
                  fa.flash_attention(q, k, v, causal=causal,
                                     window=window).float(),
                  fa.attention_plain(q, k, v, causal=causal,
                                     window=window).float(), RTOL[dtype])
    p = ATTN_WIDE_HEADS
    bh, bh_kv, s, d = p["bh"], p["bh_kv"], p["seq"], p["d"]
    q = randn(rng, (bh, s, d), device)
    k, v = randn(rng, (bh_kv, s, d), device), randn(rng, (bh_kv, s, d), device)
    pl = fa.plan(128, 128, s, d)
    print(f"  plan (128,128) d {d}: {pl.instantiation}, {pl.groups} row "
          f"groups, q sub-tile {pl.sub_q} ({pl.q_sub_tiles(128)} a tile), "
          f"kv sub-tile {pl.sub_kv}, {pl.col_blocks} blocks a q tile, "
          f"{bh * (s // 128) * pl.col_blocks} blocks")
    for window in ATTN_WIDE_WINDOWS:
        agree(f"flash_attention {bh}x{s}x{d} over {bh_kv} kv head causal "
              f"window {window} tiles (128,128)",
              fa.flash_attention(q, k, v, window=window),
              fa.attention_plain(q, k, v, window=window),
              RTOL[torch.float32])
        ms = time_ms(lambda: fa.flash_attention(q, k, v, window=window))
        pairs = sum(min(i + 1, window or s) for i in range(s))
        flops = 4.0 * bh * pairs * d
        print(f"  flash_attention {bh}x{s}x{d} causal window {window} "
              f"(128,128): kernel {ms:.4f} ms ({flops / ms / 1e9:.2f} "
              f"TFLOP/s of the useful {flops / 1e9:.2f} GFLOP), operations "
              f"bound {flops / PEAK_F32_FLOPS * 1e3:.4f} ms")


def check_ssd(device: str) -> dict:
    """SSD kernels vs ``ssd_plain`` at tests/test_kernels.py's shapes and
    distributions and at a state of 256, then at mamba2-130m's width on the
    recording's inputs at every chunk of SSD_CHUNKS; each chunk timed
    whole and pass by pass, beside the operations bound and the chunked
    algorithm's floor; the JSON row at the first chunk."""
    from repro_torch.kernels import ssd
    rng = np.random.default_rng(7)
    softplus = torch.nn.functional.softplus
    for bh, l, pp, n, chunks in ((3, 256, 16, 8, (32, 64, 128)),
                                 (2, 512, 80, 256, (64, 512))):
        x, b, c = (randn(rng, s, device) for s in ((bh, l, pp), (bh, l, n),
                                                   (bh, l, n)))
        dt = softplus(randn(rng, (bh, l), device)) * 0.1
        a = -softplus(randn(rng, (bh,), device))
        for chunk in chunks:
            y, h = ssd.ssd_scan(x, dt, a, b, c, chunk=chunk,
                                final_state=True)
            y_ref, h_ref = ssd.ssd_plain(x, dt, a, b, c, chunk=chunk,
                                         final_state=True)
            agree(f"ssd {bh}x{l} P {pp} N {n} chunk {chunk}", y, y_ref,
                  SSD_TOL)
            agree(f"ssd {bh}x{l} P {pp} N {n} chunk {chunk} final state", h,
                  h_ref, SSD_TOL)
    p = HUB_PROBLEMS["ssd"]
    bh, l, pp, n = p["bh"], p["seq"], p["p"], p["n"]
    args = ssd.live_inputs(p, device)
    flops = ssd.needed_flops(**p)
    ops_ms = flops / PEAK_F32_FLOPS * 1e3
    bytes_ms = (nbytes(*args) + args[0].numel() * 4) / PEAK_BYTES * 1e3
    row = None
    for chunk in SSD_CHUNKS:
        err = agree(f"ssd {bh}x{l} P {pp} N {n} chunk {chunk}",
                    ssd.ssd_scan(*args, chunk=chunk),
                    ssd.ssd_plain(*args, chunk=chunk), SSD_TOL)
        ms = time_ms(lambda: ssd.ssd_scan(*args, chunk=chunk))
        passes = ssd_pass_ms(args, chunk)
        plain = spread_ms(lambda: ssd.ssd_plain(*args, chunk=chunk))
        work = ssd.chunked_flops(**p, chunk=chunk)
        floor_ms = work / PEAK_F32_FLOPS * 1e3
        print(f"  ssd {bh}x{l} chunk {chunk}: kernels {ms:.4f} ms "
              f"({flops / ms / 1e9:.2f} TFLOP/s of the needed "
              f"{flops / 1e9:.2f} GFLOP, {work / ms / 1e9:.2f} of the "
              f"chunked {work / 1e9:.2f}); passes: chunk states "
              f"{passes[0]:.4f}, state pass {passes[1]:.4f}, chunk outputs "
              f"{passes[2]:.4f} ms; plain median {plain[0]:.4f} ms (min "
              f"{plain[1]:.4f}, max {plain[2]:.4f}, host enqueue median "
              f"{plain[3]:.4f}); bound {max(ops_ms, bytes_ms):.4f} ms "
              f"(operations {ops_ms:.4f}, bytes {bytes_ms:.4f}), algorithm "
              f"floor {floor_ms:.4f} ms")
        if chunk == SSD_CHUNKS[0]:
            agree(f"ssd {bh}x{l} P {pp} N {n} chunk {chunk} final state",
                  ssd.ssd_scan(*args, chunk=chunk, final_state=True)[1],
                  ssd.ssd_plain(*args, chunk=chunk, final_state=True)[1],
                  SSD_TOL)
            row = kernel_row("ssd", "src/repro_torch/kernels/csrc/ssd.cu",
                             "src/repro/kernels/ssd.py:39", err, ms,
                             plain[0], ops_ms, bytes_ms, None)
    return row


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


def commit_rows_ms(cache, length: int, batches: int, device: str) -> tuple:
    """``(median, min, max, first)`` host wall in ms of one
    ``ReplayEngine.commit_rows`` call of ``length`` fresh rows (distinct
    rows of one permutation, no budget cap) on a fresh
    ``SimulationRunner(engine="torch")``, over ``batches`` calls after the
    first, which lays out the runner's blocks and is timed apart; each
    call ends synchronised."""
    from repro_torch.core.budget import Budget
    from repro_torch.core.runner import SimulationRunner
    runner = SimulationRunner(cache, Budget(), engine="torch", device=device)
    engine = runner.torch_engine()
    rows = np.random.default_rng(3).permutation(cache.space.compiled.n_valid)
    if (batches + 1) * length > len(rows):
        fail(f"commit_rows_ms: {batches + 1} batches of {length} rows "
             f"exceed the space")
    t0 = time.perf_counter()
    engine.commit_rows(rows[:length])
    first = (time.perf_counter() - t0) * 1e3
    walls = []
    for b in range(1, batches + 1):
        batch = rows[b * length:(b + 1) * length]
        t0 = time.perf_counter()
        engine.commit_rows(batch)
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls), min(walls), max(walls), first


LATENCY_SRC = r"""
#include <cuda_runtime.h>

__device__ __forceinline__ unsigned long long now_after(long long dep) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) : "l"(dep));
  return t;
}

__global__ void chase(const long long* __restrict__ next, int steps,
                      long long* sink, unsigned long long* ns) {
  long long i = 0;
  for (int s = 0; s < steps; ++s) i = next[i];
  const unsigned long long t0 = now_after(i);
  for (int s = 0; s < steps; ++s) i = next[i];
  const unsigned long long t1 = now_after(i);
  sink[0] = i;
  ns[0] = t1 - t0;
}

__global__ void add_chain(double x, double y, int steps, double* sink,
                          unsigned long long* ns) {
  double t = x;
  const unsigned long long t0 = now_after(__double_as_longlong(t));
#pragma unroll 16
  for (int s = 0; s < steps; ++s) t = __dadd_rn(t, y);
  const unsigned long long t1 = now_after(__double_as_longlong(t));
  sink[0] = t;
  ns[0] = t1 - t0;
}

extern "C" int probe_latency(const void* next, int chase_steps,
                             int add_steps, void* sink, void* ns) {
  chase<<<1, 1>>>(static_cast<const long long*>(next), chase_steps,
                  static_cast<long long*>(sink),
                  static_cast<unsigned long long*>(ns));
  add_chain<<<1, 1>>>(1.0, 1e-9, add_steps,
                      static_cast<double*>(sink) + 1,
                      static_cast<unsigned long long*>(ns) + 1);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""
LATENCY_LIB = ROOT / "build" / "latency_probe" / "latency.so"
CHASE_ENTRIES = 1 << 19  # 4 MB of int64: in L2, past L1
CHASE_STEPS = 1 << 14
ADD_STEPS = 1 << 20


def start_latency_build() -> subprocess.Popen:
    """Start nvcc on the latency probe (``latency_ns``), to run beside the
    kernels' builds."""
    from repro_torch import cuda
    src = LATENCY_LIB.with_suffix(".cu")
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(LATENCY_SRC)
    return subprocess.Popen(
        [cuda.toolkit(), *cuda.NVCC_FLAGS, "-o", str(LATENCY_LIB), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def latency_ns(build: subprocess.Popen) -> tuple:
    """``(load, add)``: ns of one dependent global load that hits L2 (a
    pointer chase of 16,384 steps through a random cycle over 4 MB, after
    one untimed pass) and of one dependent float64 add (a chain of 2**20
    ``__dadd_rn``) on the card, each timed by ``%globaltimer`` inside a
    one-thread kernel; ``build`` is ``start_latency_build()``'s nvcc."""
    import ctypes
    log = build.communicate()[0]
    if build.returncode:
        fail(f"nvcc failed for the latency probe:\n{log}")
    lib = ctypes.CDLL(str(LATENCY_LIB))
    lib.probe_latency.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_void_p]
    perm = np.random.default_rng(0).permutation(CHASE_ENTRIES)
    nxt = np.empty(CHASE_ENTRIES, dtype=np.int64)
    nxt[perm] = np.roll(perm, -1)  # one cycle through every entry
    nxt_d = torch.from_numpy(nxt).cuda()
    sink = torch.zeros(2, dtype=torch.int64, device="cuda")
    ns = torch.zeros(2, dtype=torch.int64, device="cuda")
    rc = lib.probe_latency(nxt_d.data_ptr(), CHASE_STEPS, ADD_STEPS,
                           sink.data_ptr(), ns.data_ptr())
    if rc:
        fail(f"the latency probe failed (cudaError {rc})")
    chase, add = ns.tolist()
    return chase / CHASE_STEPS, add / ADD_STEPS


def scan_r1_cases(args: tuple, length: int) -> dict:
    """R = 1 inputs over the first ``length`` entries of ``args``' run 0
    (which has no cap): ``none`` as it is, ``time`` and ``count`` with a
    cap by time and by count that each refuse the segment's middle
    entry."""
    from repro_torch.core.engine_torch import replay as rp
    none = (args[0][:1, :length].contiguous(), args[1][:1, :length],
            *args[2:6], *(t[:1] for t in args[6:]))
    mid = length // 2
    t_after = rp.budget_scan_plain(*none)[1]
    return {"none": none,
            "time": (*none[:8], t_after[:, mid - 1].contiguous(), none[9]),
            "count": (*none[:9], torch.full_like(none[9], mid))}


def check_packed_commit(cache, length: int, device: str) -> None:
    """One ``ReplayEngine.commit_rows`` call of ``length`` fresh rows, with
    an eval cap that refuses the middle one, on a fresh
    ``SimulationRunner(engine="torch")``: one launch, and its packed
    blocks' outputs (host and device) bit-identical to
    ``budget_scan_plain`` fed the device block's input views."""
    from repro_torch.core.budget import Budget, BudgetExhausted
    from repro_torch.core.engine_torch import replay as rp
    from repro_torch.core.runner import SimulationRunner
    mid = length // 2
    runner = SimulationRunner(cache, Budget(max_evals=mid), engine="torch",
                              device=device)
    engine = runner.torch_engine()
    rows = np.random.default_rng(4).permutation(
        cache.space.compiled.n_valid)[:length]
    before = rp.launches
    got = engine.commit_rows(rows)
    made = rp.launches - before
    npad = rp._pad_len(length)
    blocks = engine.blocks()
    dev_in, dev_out = blocks.device_views(npad)
    host_out = blocks.call(npad)[1]
    tables = rp.replay_tables(cache.columns, cache.space.compiled, device)
    # the engine passes the mean charge only when a fresh row is a miss
    miss = (tables.col_of_row[dev_in["rows"]][dev_in["fresh"]] < 0).any()
    want = rp.budget_scan_plain(
        dev_in["rows"], dev_in["fresh"], tables.col_of_row, tables.time_s,
        tables.charge_s, cache.mean_eval_charge() if miss else 0.0,
        dev_in["spent0"],
        dev_in["evals0"], dev_in["max_s"], dev_in["max_e"])
    same = all(torch.equal(dev_out[k], w)
               and torch.equal(torch.from_numpy(host_out[k]), w.cpu())
               for k, w in zip(rp.OUT_ORDER, want))
    print(f"  commit_rows R = 1 x {length} through the packed blocks, cap "
          f"{mid} evals: {made} launch, {runner.budget.spent_evals} "
          f"commits, outputs (host and device) vs plain "
          f"{'bit-identical' if same else 'DIFFERENT'}")
    if not same:
        fail("the packed commit_rows call disagrees with budget_scan_plain")
    if (made != 1 or not isinstance(got, BudgetExhausted)
            or runner.budget.spent_evals != mid):
        fail(f"the packed commit_rows call made {made} launches and "
             f"{runner.budget.spent_evals} commits (expected 1 and {mid}, "
             f"then BudgetExhausted)")


def scan_inputs(device: str, runs: int, seed: int = 1) -> tuple:
    """``(cache, args)``: the synthetic GEMM cache and ``budget_scan``'s
    arguments over ``runs`` full-space permutations of it, with budgets
    that run out mid-row."""
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
    return cache, args


def check_scan(device: str, runs: int,
               latency_build: subprocess.Popen) -> dict:
    """Budget-scan kernel vs its plain version: bit-identical."""
    from repro_torch.core.engine_torch import replay as rp
    cache, args = scan_inputs(device, runs)
    n = args[0].shape[1]
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
    load_ns, add_ns = latency_ns(latency_build)
    for length in SCAN_R1_LENGTHS:
        cases = scan_r1_cases(args, length)
        for cap, case in cases.items():
            got1, want1 = rp.budget_scan(*case), rp.budget_scan_plain(*case)
            same1 = all(torch.equal(x, y) for x, y in zip(got1, want1))
            print(f"  budget_scan R = 1 x {length}, cap {cap}: "
                  f"{int(got1[0].sum())} commits, exhausted "
                  f"{bool(got1[6][0])}; kernel vs plain "
                  f"{'bit-identical' if same1 else 'DIFFERENT'}")
            if not same1:
                fail(f"budget_scan R = 1 x {length} (cap {cap}) disagrees "
                     f"with its plain version")
            if bool(got1[6][0]) != (cap != "none"):
                fail(f"budget_scan R = 1 x {length}: cap {cap} did not "
                     f"cut where it should")
        one = cases["none"]
        one_ms = spread_ms(lambda: rp.budget_scan(*one), reps=20)
        kernel_ms = kernel_device_ms(lambda: rp.budget_scan(*one),
                                     "budget_scan_kernel")
        got1 = rp.budget_scan(*one)
        moved1 = nbytes(*(a for a in one if isinstance(a, torch.Tensor)),
                        *got1)
        bound1 = max(moved1 / PEAK_BYTES,
                     int(got1[0].sum().item()) / PEAK_F64_FLOPS) * 1e3
        floor1 = (3 * load_ns + length * add_ns) / 1e6
        print(f"  budget_scan R = 1 x {length} (phase 6's GA batches): "
              f"call {one_ms[0]:.4f} ms by events (min {one_ms[1]:.4f}, "
              f"host enqueue median {one_ms[3]:.4f}), kernel "
              + ("not measured" if kernel_ms is None
                 else f"{kernel_ms:.4f} ms")
              + f" on the device (torch.profiler), bound {bound1:.6f} ms "
              f"({moved1 / 1e6:.3f} MB moved), latency floor "
              f"{floor1:.6f} ms (3 dependent L2 loads of {load_ns:.1f} ns, "
              f"{length} dependent float64 adds of {add_ns:.2f} ns)")
        wall = commit_rows_ms(cache, length, COMMIT_BATCHES, device)
        print(f"  commit_rows R = 1 x {length}: wall per call median "
              f"{wall[0]:.4f} ms, min {wall[1]:.4f}, max {wall[2]:.4f} "
              f"({COMMIT_BATCHES} batches of {length} fresh rows, one "
              f"SimulationRunner(engine=\"torch\")); its first call, "
              f"which lays out the runner's blocks, {wall[3]:.4f} ms")
        check_packed_commit(cache, length, device)
    return kernel_row("budget_scan", "src/repro_torch/core/engine_torch/"
                      "csrc/budget_scan.cu",
                      "src/repro/core/engine_jax/replay.py:66", err, ms,
                      plain_ms, ops_ms, bytes_ms, None)


# ------------------------------------------------------------- phases 4-6
def record(out_dir: pathlib.Path, device: str, name: str, problem: dict,
           evals: int, max_seconds: float):
    """Live random-search recording of one kernel through
    ``record_cache``."""
    from repro_torch.core.record import RecordSpec, record_cache
    from repro_torch.kernels import get_kernel
    mod = get_kernel(name).module
    if name == "gemm":
        def fit(conf):
            return mod.fits(conf, torch.bfloat16)
    else:
        def fit(conf):
            return mod.fits(conf, problem)
    spec = RecordSpec.create(name, target=device, problem=problem,
                             strategy="random_search", repeats=3,
                             max_evals=evals, max_seconds=max_seconds,
                             seed=0)
    out = out_dir / f"{name}@{spec.device}.json.gz"
    for stale in out_dir.glob(f"{name}@*"):
        stale.unlink()
    space = get_kernel(name).space(problem)
    unfit = sum(not fit(space.as_dict(c)) for c in space.valid_configs)
    print(f"  {name}: fits() rejects {unfit} of the {space.size} tilings "
          f"before launch ({100.0 * unfit / space.size:.1f} %)")
    t0 = time.perf_counter()
    cache = record_cache(spec, str(out),
                         progress=lambda msg: print(f"  {msg}"))
    wall = time.perf_counter() - t0
    ok = [(r.time_s, k) for k, r in cache.results.items() if r.status == "ok"]
    errors = [k for k, r in cache.results.items() if r.status != "ok"]
    rejected = sum(not fit(cache.space.as_dict(cache.space.config_from_id(k)))
                   for k in errors)
    print(f"  recorded {len(cache.results)} configs of {cache.space.size} "
          f"for {name}@{spec.device} in {wall:.1f} s: {len(ok)} ok, "
          f"{len(errors) - rejected} refused at launch, {rejected} rejected "
          f"before launch by fits()")
    if not ok:
        fail(f"the {name} recording holds no ok observation")
    best, key = min(ok)
    print(f"  best {cache.space.as_dict(cache.space.config_from_id(key))}: "
          f"{best * 1e3:.4f} ms"
          + (f", {2.0 * HUB ** 3 / best / 1e12:.2f} TFLOP/s"
             if name == "gemm" else ""))
    worst, slow_key = max(ok)
    print(f"  per-config time: min {best * 1e3:.4f} ms, median "
          f"{statistics.median(t for t, _ in ok) * 1e3:.4f} ms, max "
          f"{worst * 1e3:.4f} ms (slowest "
          f"{cache.space.as_dict(cache.space.config_from_id(slow_key))}); "
          f"total charge "
          f"{sum(r.charge_s for r in cache.results.values()):.2f} s")
    return cache, out


def replay_and_score(cache, out: pathlib.Path, device: str, runs: int,
                     repeats: int, left_out: dict) -> dict:
    """``replay_many`` over the recorded cache, then the methodology with
    the torch engine on ``device`` and with the numpy engine (``left_out``
    from ``cap_guard``). Returns the budget-scan launches of the fused
    drives and the scoring, by strategy."""
    from repro_torch.core.cache import CacheFile
    from repro_torch.core.engine_torch import replay_many
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
    made = check_fused_drive(loaded, device, repeats)
    for name, n in score_both_engines([loaded], device, repeats,
                                      left_out).items():
        made[name] = made.get(name, 0) + n
    return made


def score_both_engines(caches, device: str, repeats: int,
                       left_out: dict) -> dict:
    """``evaluate_strategy`` of every strategy of ``STRATEGIES`` over
    ``caches`` (Eq. 3 aggregate) with the torch engine on ``device`` and
    with the numpy engine: scores, curves and charges must be
    bit-identical, and the torch scoring of a strategy that committed a
    fresh row must have launched the budget scan. A recording in
    ``left_out[name]`` (``cap_guard``) is not scored for ``name``. Returns
    each strategy's budget-scan launches on the torch engine."""
    from repro_torch.core.engine_torch import replay as rp
    from repro_torch.core.engine_torch.campaign import FUSED_STRATEGIES
    from repro_torch.core.methodology import evaluate_strategy, make_scorer
    from repro_torch.core.parallel import StrategyFactory
    from repro_torch.core.strategies import STRATEGIES as REGISTRY
    print(f"  scoring over {', '.join(c.kernel for c in caches)}:")
    launches = {}
    for name in STRATEGIES:
        spaces = [c for c in caches if c.kernel not in left_out.get(name, ())]
        if len(spaces) < len(caches):
            print(f"  {name:19s} leaves out "
                  f"{sorted(c.kernel for c in caches if c not in spaces)} "
                  f"(guard)")
        if not spaces:
            continue
        factory = StrategyFactory.create(name, {})
        reports = {}
        for engine in ("torch", "vectorized"):
            scorers = [make_scorer(c, engine=engine, device=device)
                       for c in spaces]
            before = rp.launches
            with AskCounter(REGISTRY[name]) as asks:
                reports[engine] = evaluate_strategy(factory, scorers,
                                                    repeats=repeats, seed=0)
            made = rp.launches - before
            r = reports[engine]
            print(f"  {name:19s} engine {engine:10s} score {r.score!r} "
                  f"({r.fresh_evals} fresh evals, {r.simulated_seconds!r} "
                  f"simulated s in {r.wall_seconds:.3f} s wall; drive "
                  f"{r.fuse}"
                  + (f"; {made} budget-scan launches)" if engine == "torch"
                     else ")"))
            if engine == "torch":
                launches[name] = made
                if r.fresh_evals and not made:
                    fail(f"{name}: the torch scoring committed "
                         f"{r.fresh_evals} fresh rows without a budget-scan "
                         f"launch")
            if name not in FUSED_STRATEGIES and asks.asks:
                runs = repeats * len(spaces)
                n = max(asks.asks, 1)
                print(f"  {'':19s} {asks.asks / runs:.1f} asks a run, "
                      f"{r.wall_seconds / n * 1e3:.5f} ms of wall an ask, "
                      f"{asks.seconds / n * 1e3:.5f} ms of it inside ask "
                      f"({asks.asks} asks over {runs} runs)")
        a, b = reports["torch"], reports["vectorized"]
        if (a.score, a.fresh_evals, a.simulated_seconds) != \
                (b.score, b.fresh_evals, b.simulated_seconds) \
                or not np.array_equal(a.curve, b.curve) \
                or a.per_space_score != b.per_space_score:
            fail(f"{name}: torch-engine scores differ from the numpy engine")
    return launches


def cap_guard(caches, repeats: int) -> dict:
    """Drive the methodology's runs of every strategy that is not
    device-fused over each recording on the numpy engine, as
    ``evaluate_strategy`` seeds them, until each ends or asks
    ``GUARD_ASKS`` times in a row without a fresh config. A run ends only
    at a fresh ask once its budget is spent, so a strategy that stops
    finding fresh configs revisits forever (basin hopping on a small whole
    space, ROADMAP Queue 3). The cap counts asks since the last fresh
    config, not asks a run: on a live GEMM recording of 512 configs
    simulated annealing asked up to 107,607 times in one run (56,444 on
    average), at most 8,273 in a row without a fresh one. Returns
    ``{strategy: {kernel, ...}}``, the recordings on which a run reached
    the cap (the first such run ends that recording's drive); they are
    left out of that strategy's scoring, and each is printed as that
    fault, not as a failure."""
    from repro_torch.core.budget import Budget
    from repro_torch.core.driver import SearchDriver
    from repro_torch.core.engine_torch.campaign import FUSED_STRATEGIES
    from repro_torch.core.methodology import _repeat_rng, make_scorer
    from repro_torch.core.runner import SimulationRunner
    from repro_torch.core.strategies import get_strategy
    scorers = [make_scorer(c, engine="vectorized") for c in caches]
    left_out: dict = {}
    for name in STRATEGIES:
        if name in FUSED_STRATEGIES:
            continue
        t0 = time.perf_counter()
        most = longest = 0
        for s in scorers:
            for r in range(repeats):
                runner = SimulationRunner(s.cache,
                                          Budget(max_seconds=s.budget_s),
                                          engine="numpy")
                d = SearchDriver(get_strategy(name), s.cache.space, runner,
                                 _repeat_rng(s, r, 0))
                asks = stale = fresh = 0
                try:
                    while stale < GUARD_ASKS and d.step():
                        asks += 1
                        stale = 0 if runner.fresh_evals > fresh else stale + 1
                        fresh = runner.fresh_evals
                        longest = max(longest, stale)
                finally:
                    d.state.close()
                most = max(most, asks)
                if stale >= GUARD_ASKS:
                    left_out.setdefault(name, set()).add(s.cache.kernel)
                    print(f"  guard: {name} run {r} on the {s.cache.kernel} "
                          f"recording asked {GUARD_ASKS} times in a row "
                          f"with no fresh config, at {runner.fresh_evals} "
                          f"fresh configs of "
                          f"{s.n_total} and {runner.budget.spent_seconds!r} "
                          f"of its {s.budget_s!r} s budget spent: it never "
                          f"ends (ROADMAP Queue 3); the recording is left "
                          f"out of {name}'s scoring")
                    break
        print(f"  guard: {name}: at most {most} asks a run and {longest} "
              f"in a row with no fresh config, over {len(scorers)} "
              f"recordings x {repeats} runs, {time.perf_counter() - t0:.3f} "
              f"s")
    return left_out


class AskCounter:
    """Counts the asks of one strategy class and the host time spent in
    them, by wrapping the class's ``ask`` while the block runs (the
    package is not touched)."""

    def __init__(self, cls):
        self.cls, self.asks, self.seconds = cls, 0, 0.0

    def __enter__(self) -> "AskCounter":
        self.own = self.cls.__dict__.get("ask")
        inner = self.cls.ask

        def ask(strategy, state):
            t0 = time.perf_counter()
            try:
                return inner(strategy, state)
            finally:
                self.asks += 1
                self.seconds += time.perf_counter() - t0

        self.cls.ask = ask
        return self

    def __exit__(self, *exc) -> None:
        if self.own is None:
            del self.cls.ask
        else:
            self.cls.ask = self.own


class ScanShapes:
    """Records the (runs, npad) of every packed budget-scan call while the
    block runs, and the host wall of the calls (copies, launch and
    synchronisation), by wrapping ``ScanBlocks.run`` (launches still count
    in ``replay.launches`` alone)."""

    def __enter__(self) -> "ScanShapes":
        from repro_torch.core.engine_torch import replay as rp
        self.shapes: list = []
        self.seconds = 0.0
        self.inner = inner = rp.ScanBlocks.run

        def run(blocks, npad, tables, mean_charge, runs=1):
            self.shapes.append((runs, npad))
            t0 = time.perf_counter()
            try:
                return inner(blocks, npad, tables, mean_charge, runs=runs)
            finally:
                self.seconds += time.perf_counter() - t0

        rp.ScanBlocks.run = run
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.core.engine_torch import replay as rp
        rp.ScanBlocks.run = self.inner

    def summary(self) -> str:
        def hist(values):
            return ", ".join(f"{v}: {values.count(v)}"
                             for v in sorted(set(values)))
        return (f"R a launch {{{hist([r for r, _ in self.shapes])}}}, "
                f"segment length {{{hist([n for _, n in self.shapes])}}}, "
                f"{self.seconds:.4f} s of host wall in the packed calls")


def runner_state(runner) -> tuple:
    return (runner.trace, sorted(runner.memo), runner.budget.spent_seconds,
            runner.budget.spent_evals, runner.fresh_evals)


def check_fused_drive(cache, device: str, repeats: int) -> dict:
    """``drive_many(fuse="device")`` on ``device`` against the numpy
    ``drive_many`` over ``cache`` with the methodology's budget, for every
    strategy of ``FUSED_CHECK`` (``materialize=True``): each runner's
    trace, memo keys, budget floats, fresh evaluations and exhaustion
    bit-identical, and every fused driver on the device path. Returns each
    strategy's budget-scan launches."""
    from repro_torch.core.budget import Budget
    from repro_torch.core.driver import SearchDriver, drive_many
    from repro_torch.core.engine_torch import replay as rp
    from repro_torch.core.methodology import make_scorer
    from repro_torch.core.runner import SimulationRunner
    from repro_torch.core.strategies import get_strategy
    budget_s = make_scorer(cache, engine="vectorized").budget_s
    launches = {}
    for name in FUSED_CHECK:
        drivers, walls = {}, {}
        for engine in ("torch", "numpy"):
            drivers[engine] = [SearchDriver(
                get_strategy(name), cache.space,
                SimulationRunner(cache, Budget(max_seconds=budget_s),
                                 engine=engine, device=device),
                random.Random(r)) for r in range(repeats)]
            before = rp.launches
            t0 = time.perf_counter()
            drive_many(drivers[engine],
                       fuse="device" if engine == "torch" else None)
            walls[engine] = time.perf_counter() - t0
            if engine == "torch":
                made = launches[name] = rp.launches - before
        same = all(runner_state(a.runner) == runner_state(b.runner)
                   and a.exhausted == b.exhausted
                   for a, b in zip(drivers["torch"], drivers["numpy"]))
        modes = {d.fuse for d in drivers["torch"]}
        print(f"  drive_many {name}, {repeats} runs on the {cache.kernel} "
              f"recording: fuse=\"device\" {walls['torch']:.3f} s wall, "
              f"{made} budget-scan launches, drive {modes}; numpy "
              f"{walls['numpy']:.3f} s; runner state "
              f"{'bit-identical' if same else 'DIFFERENT'}")
        if not same or modes != {"device"}:
            fail(f"drive_many(fuse='device') of {name} differs from the "
                 f"numpy drive_many or left the device path ({modes})")
    return launches


def ends_check(caches) -> None:
    """Refuse a recording on which a tuning run might never end. A run ends
    only at a fresh evaluation asked once its budget is spent, so the GA,
    simulated annealing and PSO, which revisit configurations for free,
    restart forever unless the methodology's budget runs out before the
    last fresh configuration (ROADMAP Queue 3)."""
    from repro_torch.core.methodology import make_scorer
    for s in (make_scorer(c, engine="vectorized") for c in caches):
        charges = s.cache.columns.charge_s
        total = float(charges.sum())
        print(f"  {s.name}: budget {s.budget_s:.4f} s of {total:.4f} s "
              f"total charge, {s.n_total} configs")
        if not s.budget_s < total - float(charges.max()):
            fail(f"{s.name}: the methodology's budget reaches the whole "
                 f"charge; a tuning run would never end")


def time_limit(phase: int, limit_s: int):
    """Fail the script when the rest of ``phase`` outlasts ``limit_s``
    seconds of wall clock (``signal.alarm(0)`` lifts the limit)."""
    def over_time(signum, frame):
        fail(f"phase {phase} ran over its {limit_s} s wall-clock limit")

    signal.signal(signal.SIGALRM, over_time)
    signal.alarm(limit_s)


def hypertune(caches, device: str, repeats: int, limit_s: int) -> int:
    """Exhaustive GA hypertuning (Table III grid) across ``caches`` with
    the torch engine (device-fused), then the same campaign with the
    numpy engine, twice, and with the torch engine again: all scores must
    be bit-identical, and the best, closest-to-mean and worst
    configurations rescored with the numpy engine too. Prints each wall,
    the torch runs' budget-scan launches, their R and segment lengths and
    the host wall of the packed calls. Fails past ``limit_s`` seconds of
    wall clock. The recordings must have passed ``ends_check``. Returns
    the torch runs' budget-scan launches."""
    from repro_torch.core.engine_torch import replay as rp
    from repro_torch.core.hypertuner import (exhaustive_hypertune,
                                             score_hyperconfig)
    from repro_torch.core.methodology import make_scorer
    scorers = [make_scorer(c, engine="torch", device=device) for c in caches]
    numpy_scorers = [make_scorer(c, engine="vectorized") for c in caches]
    time_limit(6, limit_s)
    try:
        walls: dict = {"torch": [], "numpy": []}
        results = []
        launches = 0
        # the main path's torch run first, then numpy, numpy, torch: the
        # two engines' walls compare only in turns on one card
        for engine in ("torch", "numpy", "numpy", "torch"):
            before = rp.launches
            t0 = time.perf_counter()
            with ScanShapes() as shapes:
                res = exhaustive_hypertune(
                    "genetic_algorithm",
                    scorers if engine == "torch" else numpy_scorers,
                    repeats=repeats, seed=0)
            wall = time.perf_counter() - t0
            scans = rp.launches - before
            if engine == "torch":
                launches += scans
            walls[engine].append(wall)
            results.append(res)
            modes = {r.report.fuse for r in res.results.values()}
            print(f"  {engine} engine: {len(res.results)} GA "
                  f"hyperconfigurations x {repeats} repeats x "
                  f"{len(scorers)} spaces in {wall:.3f} s wall "
                  f"({res.simulated_seconds:.1f} simulated s), drive "
                  f"{modes}; {scans} budget-scan launches"
                  + (f", {wall / scans * 1e3:.4f} ms of wall a launch"
                     if scans else ""))
            if engine == "torch":
                print(f"  torch engine: {shapes.summary()}")
                if modes != {"device"}:
                    fail(f"hypertune: the GA campaign left the device path "
                         f"({modes})")
        res = results[0]
        differ = sorted({k for other in results[1:]
                         for k, r in res.results.items()
                         if r.score != other.results[k].score
                         or not np.array_equal(
                             r.report.curve, other.results[k].report.curve)})
        print(f"  torch / numpy: {sum(walls['torch']):.3f} s against "
              f"{sum(walls['numpy']):.3f} s over two runs each "
              f"({sum(walls['torch']) / sum(walls['numpy']):.3f}); "
              f"{len(res.results) - len(differ)} of {len(res.results)} "
              f"scores bit-identical across the four runs")
        if differ or any(r.results.keys() != res.results.keys()
                         for r in results):
            fail(f"hypertune: {len(differ)} hyperconfigurations score "
                 f"differently with the numpy engine")
        best, avg = res.best, res.closest_to_mean()
        rel = (best.score - avg.score) / max(abs(avg.score), 1e-2)
        print(f"  optimal vs average config: {best.score:+.4f} vs "
              f"{avg.score:+.4f} ({100*rel:+.1f}%; paper Sec. IV-B reports "
              f"+94.8% on average)")
        for label, r in (("best", best), ("closest to mean", avg),
                         ("worst", res.worst)):
            rep = score_hyperconfig("genetic_algorithm", r.hyperparams,
                                    numpy_scorers, repeats=repeats, seed=0)
            same = (rep.score == r.score
                    and np.array_equal(rep.curve, r.report.curve)
                    and rep.per_space_score == r.report.per_space_score)
            print(f"  {label:16s} {r.hyperparams}: torch {r.score!r}, numpy "
                  f"{rep.score!r} {'bit-identical' if same else 'DIFFERENT'}")
            if not same:
                fail(f"hypertune: the {label} configuration scores "
                     f"differently with the numpy engine")
        return launches
    finally:
        signal.alarm(0)


def meta_campaign(caches, device: str, repeats: int, out_dir: pathlib.Path,
                  limit_s: int) -> int:
    """The paper's meta-strategy path (Eq. 4): ``meta_hypertune`` of the GA
    over its extended grid with dual annealing as the meta-strategy (its
    scipy loop on the driver's thread bridge, every inner campaign on this
    thread), ``META_EVALS`` configurations scored, each journaled to a file
    in a temporary directory under ``out_dir``; torch engine, then numpy
    engine. Every evaluated score, the trace and the best configuration
    must be bit-identical, and no bridge thread may outlive the campaign.
    Fails past ``limit_s`` seconds of wall clock. Returns the torch
    campaign's budget-scan launches."""
    from repro_torch.core.engine_torch import replay as rp
    from repro_torch.core.hypertuner import meta_hypertune
    from repro_torch.core.methodology import make_scorer
    from repro_torch.core.parallel import CampaignJournal
    time_limit(6, limit_s)
    try:
        results = {}
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            for engine in ("torch", "vectorized"):
                scorers = [make_scorer(c, engine=engine, device=device)
                           for c in caches]
                journal = CampaignJournal(str(pathlib.Path(tmp)
                                              / f"meta-{engine}.jsonl"))
                before = rp.launches
                t0 = time.perf_counter()
                res = meta_hypertune("genetic_algorithm", "dual_annealing",
                                     scorers, extended=True,
                                     max_hp_evals=META_EVALS,
                                     repeats=repeats, seed=0,
                                     journal=journal)
                wall = time.perf_counter() - t0
                made = rp.launches - before
                records = len(journal.read()[1])
                results[engine] = res
                print(f"  meta {engine:10s}: dual annealing over the GA's "
                      f"extended grid, {len(res.evaluated)} configurations x "
                      f"{repeats} repeats x {len(caches)} spaces in "
                      f"{wall:.3f} s wall, inner drive {res.fuse}, "
                      f"{records} journal records"
                      + (f", {made} budget-scan launches"
                         if engine == "torch" else "")
                      + f"; best {res.best_hyperparams} {res.best_score!r}")
                if engine == "torch":
                    launches = made
                    if not made or res.fuse != "device":
                        fail(f"meta: the torch campaign made {made} "
                             f"budget-scan launches, inner drive {res.fuse}")
        a, b = results["torch"], results["vectorized"]
        same = (list(a.evaluated.items()) == list(b.evaluated.items())
                and a.best_hyperparams == b.best_hyperparams
                and a.best_score == b.best_score
                and [t[:2] for t in a.trace] == [t[:2] for t in b.trace])
        bridges = [t.name for t in threading.enumerate()
                   if t.name == "repro-bridge"]
        print(f"  meta torch / numpy: {a.wall_seconds / b.wall_seconds:.3f}; "
              f"{len(a.evaluated)} scores and the best configuration "
              f"{'bit-identical' if same else 'DIFFERENT'}; "
              f"{len(bridges)} bridge threads left")
        if not same or len(a.evaluated) != META_EVALS:
            fail("meta: the dual-annealing campaign differs between the "
                 "torch and numpy engines")
        if bridges:
            fail(f"meta: {len(bridges)} bridge threads outlived the campaign")
        return launches
    finally:
        signal.alarm(0)


# ----------------------------------------------------------------- phase 7
class Capture:
    """Keep a copy of the inputs of call number ``at`` (from 0: the first)
    of a kernel wrapper (``module.attr``) while the ``with`` block runs;
    the call itself goes on to the wrapper."""

    def __init__(self, module, attr: str, at: int = 0):
        self.module, self.attr, self.at = module, attr, at
        self.args = self.kwargs = None
        self.calls = 0

    def __enter__(self):
        wrapped = getattr(self.module, self.attr)

        def first(*args, **kwargs):
            if self.calls == self.at:
                self.args = tuple(t.detach().clone() for t in args)
                self.kwargs = dict(kwargs)
            self.calls += 1
            return wrapped(*args, **kwargs)

        setattr(self.module, self.attr, first)
        self.wrapped = wrapped
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.wrapped)


def device_profile(fn) -> dict:
    """Device time in ms by kernel of one ``fn()`` (a prefill or a decode
    step), from ``torch.profiler``'s CUDA kernel events: the
    flash-attention kernel, the SSD's three, all kernels, the number of
    kernel launches, and the ``PROFILE_TOP`` kernels that take most
    (name, ms, launches); None where the trace holds no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    if not kern:
        return None

    def ms(*names):
        return sum(e.device_time_total for e in kern
                   if not names or any(n in e.key for n in names)) / 1e3

    top = sorted(kern, key=lambda e: -e.device_time_total)[:PROFILE_TOP]
    return {"attention": ms("attn_kernel"),
            "ssd": ms("ssd_chunk_states", "ssd_state_pass",
                      "ssd_chunk_outputs"), "all": ms(),
            "launches": sum(e.count for e in kern),
            "top": [(e.key, e.device_time_total / 1e3, e.count)
                    for e in top]}


def check_serve_attention(args: tuple, kwargs: dict) -> None:
    """The first shared-attention call of a zamba2-1.2b prefill, as
    captured: the kernel against ``attention_plain`` (bf16 RTOL), timed
    beside the plain version, SDPA and the operations bound."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = args
    bh, s, d = q.shape
    agree(f"serve attention {bh}x{s}x{d} bf16 causal tiles "
          f"({kwargs['block_q']},{kwargs['block_kv']})",
          fa.flash_attention(q, k, v, **kwargs).float(),
          fa.attention_plain(q, k, v, causal=kwargs["causal"],
                             window=kwargs["window"]).float(),
          RTOL[torch.bfloat16])
    ms = time_ms(lambda: fa.flash_attention(q, k, v, **kwargs))
    plain_ms = time_ms(lambda: fa.attention_plain(q, k, v, causal=True))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(q[None], k[None], v[None],
                                      is_causal=True))
    flops = 4.0 * bh * s * (s + 1) / 2 * d
    ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = (nbytes(q, k, v) + nbytes(q)) / PEAK_BYTES * 1e3
    print(f"  serve attention {bh}x{s}x{d} bf16: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound "
          f"{max(ops_ms, bytes_ms):.4f} ms (operations {ops_ms:.4f} at "
          f"the bf16 rate, bytes {bytes_ms:.4f})")


def check_serve_ssd(args: tuple, kwargs: dict, heads: int,
                    layers: int) -> None:
    """The first Mamba layer's SSD call of a zamba2-1.2b prefill, as
    captured: y and the final state against ``ssd_plain`` (3e-3), timed
    pass by pass beside the plain version and the bound. The route copies
    B and C, (B, S, N) in the model, once per head of ``heads``: the bound
    counts them at the model's size, and the copies are timed apart, for
    one layer and for the ``layers`` of a prefill."""
    from repro_torch.kernels import ssd
    x, dt, a, b, c = args
    bh, l, pp = x.shape
    n, chunk = b.shape[-1], kwargs["chunk"]
    bsz = bh // heads
    b_model, c_model = (t.view(bsz, heads, l, n)[:, 0].contiguous()
                        for t in (b, c))
    y, h = ssd.ssd_scan(*args, chunk=chunk, final_state=True)
    y_ref, h_ref = ssd.ssd_plain(*args, chunk=chunk, final_state=True)
    agree(f"serve ssd {bh}x{l} P {pp} N {n} chunk {chunk}: y", y, y_ref,
          SSD_TOL)
    agree(f"serve ssd {bh}x{l} P {pp} N {n} chunk {chunk}: final state", h,
          h_ref, SSD_TOL)
    ms = time_ms(lambda: ssd.ssd_scan(*args, chunk=chunk, final_state=True))
    passes = ssd_pass_ms(args, chunk)
    plain_ms = time_ms(lambda: ssd.ssd_plain(*args, chunk=chunk,
                                             final_state=True))
    problem = {"bh": bh, "seq": l, "p": pp, "n": n}
    ops_ms = ssd.needed_flops(**problem) / PEAK_F32_FLOPS * 1e3
    floor_ms = ssd.chunked_flops(**problem, chunk=chunk) / PEAK_F32_FLOPS \
        * 1e3
    bytes_ms = (nbytes(x, dt, a, b_model, c_model) + nbytes(y, h)) \
        / PEAK_BYTES * 1e3
    # the route's per-head copies, as models/mamba2.py's _ssd_chunked
    expand_ms = time_ms(lambda: [
        t[:, None].expand(bsz, heads, l, n).reshape(bh, l, n).contiguous()
        for t in (b_model, c_model)])
    print(f"  serve ssd {bh}x{l} P {pp} N {n} chunk {chunk}: kernels "
          f"{ms:.4f} ms (passes without the final state: chunk states "
          f"{passes[0]:.4f}, state pass {passes[1]:.4f}, chunk outputs "
          f"{passes[2]:.4f}), plain {plain_ms:.4f} ms, bound "
          f"{max(ops_ms, bytes_ms):.4f} ms (operations {ops_ms:.4f}, bytes "
          f"{bytes_ms:.4f}, B and C at the model's {bsz}x{l}x{n}), "
          f"algorithm floor {floor_ms:.4f} ms; the route's copies of B and "
          f"C per head ({heads}x, {nbytes(b, c) / 1e6:.1f} MB) "
          f"{expand_ms:.4f} ms a layer, {expand_ms * layers:.3f} ms over "
          f"{layers} layers")


def serve(device: str, card: str, limit_s: int) -> dict:
    """Phase 7: serve zamba2-1.2b at full width (random weights from a
    seeded generator) through ``ServingEngine``. Returns the phase's
    kernel launches (flash attention and SSD) on its main path, which is
    (d). Fails past ``limit_s`` seconds of wall clock."""
    from repro_torch.configs import get_config
    from repro_torch.inference.engine import Request, ServingEngine
    from repro_torch.kernels import ALL_KERNELS
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
    from repro_torch.models import transformer as tf
    from repro_torch.models.mamba2 import dims
    time_limit(7, limit_s)
    try:
        cfg = get_config(SERVE_ARCH)
        sites = cfg.n_layers // cfg.shared_attn_every
        t0 = time.perf_counter()
        model = tf.init_params(
            cfg, torch.Generator(device=device).manual_seed(0),
            device=device)
        engine = ServingEngine(cfg, model, max_len=SERVE_MAX_LEN)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        print(f"  (a) {cfg.name} at full width: {n_params:,} float32 "
              f"parameters ({n_params * 4 / 1e9:.3f} GB), built in "
              f"{time.perf_counter() - t0:.2f} s; "
              f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
        gen = torch.Generator(device=device).manual_seed(1)
        tokens = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                               generator=gen, device=device)
        # (b) the first Mamba layer's and the first shared attention's
        # kernel inputs, captured from one prefill
        before = (fa.launches, ssd.launches)
        with Capture(fa, "flash_attention") as attn, \
                Capture(ssd, "ssd_scan") as scan, torch.inference_mode():
            tf.prefill(cfg, model, {"tokens": tokens}, SERVE_MAX_LEN)
        made = (fa.launches - before[0], ssd.launches - before[1])
        print(f"  (b) one prefill of {SERVE_BATCH} x {SERVE_PROMPT}: "
              f"{made[0]} flash-attention and {made[1]} SSD launches")
        if made != (sites, cfg.n_layers):
            fail(f"serve: a prefill made {made} launches, not "
                 f"({sites}, {cfg.n_layers})")
        with torch.inference_mode():
            check_serve_attention(attn.args, attn.kwargs)
            check_serve_ssd(scan.args, scan.kwargs, dims(cfg)[1],
                            cfg.n_layers)
            # (c) prefill of s - 1 tokens and one decode step against
            # forward (tests/test_models.py:73-79's tolerances)
            full = tf.forward(cfg, model, {"tokens": tokens})
            last, cache, n = tf.prefill(
                cfg, model, {"tokens": tokens[:, :-1]}, SERVE_MAX_LEN)
            step, _ = tf.decode_step(cfg, model, cache, tokens[:, -1:], n)
            err_last = (last - full[:, -2]).abs().max().item()
            spread = full[:, -1].std().item() + 1e-6
            err_step = (step - full[:, -1]).abs().max().item()
            ok = (bool(torch.isfinite(full).all()) and err_last < 0.05
                  and err_step / spread < 0.3)
            print(f"  (c) prefill of {SERVE_PROMPT - 1} tokens against "
                  f"forward: max |err| {err_last:.6g} (limit 0.05); one "
                  f"decode step: max |err| {err_step:.6g}, "
                  f"{err_step / spread:.4f} of the logits' spread "
                  f"{spread:.4f} (limit 0.3) {'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail("serve: prefill and decode disagree with forward")
            # one more step, at the next position, with its position on
            # the card as the engine holds it: the card's busy share and
            # launches against the step's time (rewritten in place)
            pos = torch.full((SERVE_BATCH,), n + 1, device=device)

            def one_step():
                return tf.decode_step(cfg, model, cache, tokens[:, -1:], pos)

            step_ms, lo, hi, host_ms = spread_ms(one_step)
            dprof = device_profile(one_step)
            busy = ("not measured (the profiler traced no kernel)"
                    if dprof is None else
                    f"kernels {dprof['all']:.3f} ms of device time "
                    f"({dprof['all'] / step_ms:.3f} of the step) in "
                    f"{dprof['launches']} launches, "
                    f"{step_ms * 1e3 / dprof['launches']:.2f} us of step "
                    f"a launch")
            print(f"  (c) [{card}] a decode step at batch {SERVE_BATCH}: "
                  f"{step_ms:.3f} ms (CUDA events, median of 7, "
                  f"{lo:.3f}-{hi:.3f}; host {host_ms:.3f} ms until it "
                  f"returns); {busy}")
            del full, cache
        # (d) the main path: requests through the serving engine
        reqs = [Request(prompt=row, max_new_tokens=SERVE_NEW)
                for row in tokens.tolist()]
        for mod in ALL_KERNELS.values():
            mod.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs = engine.generate(reqs)
        wall = time.perf_counter() - t0
        launches = {name: mod.launches for name, mod in ALL_KERNELS.items()}
        peak = torch.cuda.max_memory_allocated() / 1e9
        t = engine.timings
        new = sum(len(o) for o in outs)
        device_s = (t["prefill_ms"] + t["decode_ms"]) / 1e3
        prompt_rate = SERVE_BATCH * SERVE_PROMPT / t["prefill_ms"] * 1e3
        print(f"  (d) {SERVE_BATCH} requests of {SERVE_PROMPT} tokens, "
              f"{SERVE_NEW} new each, max_len {SERVE_MAX_LEN}: launches "
              f"{launches}")
        if launches != {**{k: 0 for k in launches}, "flash_attention": sites,
                        "ssd": cfg.n_layers}:
            fail(f"serve: one generate made {launches} kernel launches")
        if [len(o) for o in outs] != [SERVE_NEW] * SERVE_BATCH or not all(
                0 <= x < cfg.vocab for o in outs for x in o):
            fail("serve: the engine returned malformed tokens")
        print(f"  (e) [{card}] prefill {t['prefill_ms']:.3f} ms; decode "
              f"{t['decode_ms'] / t['steps']:.4f} ms a token "
              f"({t['steps']} steps of batch {SERVE_BATCH}); "
              f"{new / device_s:.1f} tokens/s generated over prefill + "
              f"decode ({prompt_rate:.0f} prompt tokens/s in prefill); "
              f"host wall {wall:.3f} s; peak "
              f"memory {peak:.3f} GB")
        with torch.inference_mode():
            prof = device_profile(lambda: tf.prefill(
                cfg, model, {"tokens": tokens}, SERVE_MAX_LEN))
            pre_ms = time_ms(lambda: tf.prefill(
                cfg, model, {"tokens": tokens}, SERVE_MAX_LEN), reps=5)
        if prof is None:
            print(f"  (e) [{card}] kernels' share of prefill: not measured "
                  f"(the profiler traced no kernel)")
        else:
            print(f"  (e) [{card}] prefill {pre_ms:.3f} ms (CUDA events, "
                  f"median of 5); device time by torch.profiler: all "
                  f"kernels {prof['all']:.3f} ms ({prof['all'] / pre_ms:.3f}"
                  f" of the prefill, so {1 - prof['all'] / pre_ms:.3f} "
                  f"idle), flash attention {prof['attention']:.3f} ms "
                  f"({sites} launches, {prof['attention'] / pre_ms:.3f}), "
                  f"SSD {prof['ssd']:.3f} ms ({cfg.n_layers} launches, "
                  f"{prof['ssd'] / pre_ms:.3f})")
            for key, ms, count in prof["top"]:
                print(f"    {ms:9.3f} ms {count:5d}x {key[:90]}")
        return {"flash_attention": launches["flash_attention"],
                "ssd": launches["ssd"]}
    finally:
        signal.alarm(0)


# ----------------------------------------------------------------- phase 8
def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Relative Frobenius error of ``out`` against ``ref``, in float64."""
    out, ref = out.double(), ref.double()
    return ((out - ref).norm() / ref.norm().clamp_min(1e-30)).item()


def grads_agree(what: str, names, ours, refs, tol: float,
                oracle: str = "autograd through the plain version") -> float:
    """Each of ``ours`` (an output, then gradients) within ``tol`` of
    ``refs`` (from ``oracle``) by relative Frobenius error; returns the
    largest max |err|."""
    worst = 0.0
    for name, out, ref in zip(names, ours, refs):
        err = rel_err(out, ref)
        ok = bool(torch.isfinite(out).all()) and err <= tol  # NaN fails
        print(f"  {what}: {name} relative error {err:.3g} (limit {tol:g}), "
              f"max |err| {(out.float() - ref.float()).abs().max().item():.4g}"
              f" {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{what}: {name} disagrees with {oracle}")
        worst = max(worst, (out.float() - ref.float()).abs().max().item())
    return worst


def check_train_attention(args: tuple, kwargs: dict) -> dict:
    """The first flash-attention call of a zamba2-1.2b train step, as
    captured: the kernel's lse against the plain logsumexp (float32
    RTOL); the ``_Flash`` Function (kernel forward, PyTorch backward)
    against autograd through ``attention_plain`` on the card, output and
    dq, dk, dv within the bf16 RTOL by relative error; the forward (with
    the lse), the backward and the plain forward + backward timed."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention
    q, k, v = args
    bh, s, d = q.shape
    causal, window = kwargs["causal"], kwargs["window"]
    tile, kv_len = kwargs["block_q"], kwargs["kv_len"]
    plain = dict(causal=causal, window=window, kv_len=kv_len)
    out, lse = fa.flash_attention(q, k, v, **kwargs)
    _, lse_ref = fa.attention_plain(q, k, v, return_lse=True, **plain)
    agree(f"train attention {bh}x{s}x{d} {q.dtype}: lse", lse, lse_ref,
          RTOL[torch.float32])
    gen = torch.Generator(device=q.device).manual_seed(8)
    dout = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    ours = attention._Flash.apply(*leaves, tile, kwargs["block_kv"], causal,
                                  window, kv_len)
    ours = (ours, *torch.autograd.grad(ours, leaves, dout))
    ref = fa.attention_plain(*leaves, **plain)
    ref = (ref, *torch.autograd.grad(ref, leaves, dout))
    err = grads_agree(f"train attention {bh}x{s}x{d}",
                      ("out", "dq", "dk", "dv"), ours, ref,
                      RTOL[torch.bfloat16])
    fwd_ms = time_ms(lambda: fa.flash_attention(q, k, v, **kwargs))
    bwd_ms = time_ms(lambda: attention._flash_bwd(
        q, k, v, out, lse, dout, **plain))
    plain_ms = time_ms(lambda: torch.autograd.grad(
        fa.attention_plain(*leaves, **plain), leaves, dout))
    print(f"  train attention {bh}x{s}x{d}: kernel forward with lse "
          f"{fwd_ms:.4f} ms, PyTorch backward {bwd_ms:.4f} ms, plain "
          f"forward + backward {plain_ms:.4f} ms")
    return {"err": err, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
            "plain_ms": plain_ms}


def check_train_ssd(args: tuple, kwargs: dict) -> dict:
    """The first SSD call of a zamba2-1.2b train step, as captured: the
    chunks' incoming states against ``ssd_plain``'s (3e-3); the
    ``_SSDScan`` Function (kernel forward, PyTorch backward) against
    autograd through ``ssd_plain`` on the card, y and dx, ddt, da, dB, dC
    within 3e-3 by relative error; the forward (with the states), the
    backward and the plain forward + backward timed."""
    from repro_torch.kernels import ssd
    from repro_torch.models import mamba2
    x, dt, a, b, c = args
    bh, l, pp = x.shape
    chunk = kwargs["chunk"]
    y, states = ssd.ssd_scan(*args, chunk=chunk, chunk_states=True)
    _, states_ref = ssd.ssd_plain(*args, chunk=chunk, chunk_states=True)
    agree(f"train ssd {bh}x{l} P {pp} chunk {chunk}: chunk states", states,
          states_ref, SSD_TOL)
    gen = torch.Generator(device=x.device).manual_seed(9)
    dy = torch.randn(x.shape, generator=gen, device=x.device)
    leaves = [t.detach().requires_grad_() for t in args]
    ours = mamba2._SSDScan.apply(*leaves, chunk, False)
    ours = (ours, *torch.autograd.grad(ours, leaves, dy))
    ref = ssd.ssd_plain(*leaves, chunk=chunk)
    ref = (ref, *torch.autograd.grad(ref, leaves, dy))
    err = grads_agree(f"train ssd {bh}x{l}", ("y", "dx", "ddt", "da", "dB",
                                               "dC"), ours, ref, SSD_TOL)
    fwd_ms = time_ms(lambda: ssd.ssd_scan(*args, chunk=chunk,
                                          chunk_states=True))
    bwd_ms = time_ms(lambda: mamba2._ssd_bwd(*args, states, dy, None,
                                             chunk))
    plain_ms = time_ms(lambda: torch.autograd.grad(
        ssd.ssd_plain(*leaves, chunk=chunk), leaves, dy))
    print(f"  train ssd {bh}x{l} P {pp} chunk {chunk}: kernels forward with "
          f"the states {fwd_ms:.4f} ms, PyTorch backward {bwd_ms:.4f} ms, "
          f"plain forward + backward {plain_ms:.4f} ms")
    return {"err": err, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
            "plain_ms": plain_ms}


def train_profile(fn) -> dict:
    """Device time in ms of one ``fn()`` (a train step) from
    ``torch.profiler``: all kernels and their launches, the
    flash-attention kernel, the SSD's three, the kernels launched under
    the two backward Functions' autograd nodes, and the ``PROFILE_TOP``
    kernels that take most (name, ms, launches); None where the trace
    holds no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kern = [e for e in events
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    if not kern:
        return None

    def ms(*names):
        return sum(e.device_time_total for e in kern
                   if not names or any(n in e.key for n in names)) / 1e3

    def node_ms(name):
        return sum(e.device_time_total for e in events
                   if getattr(e, "device_type", None) == DeviceType.CPU
                   and e.key.startswith("autograd::engine::evaluate_function")
                   and e.key.endswith(name)) / 1e3

    top = sorted(kern, key=lambda e: -e.device_time_total)[:PROFILE_TOP]
    return {"all": ms(), "launches": sum(e.count for e in kern),
            "attention": ms("attn_kernel"),
            "ssd": ms("ssd_chunk_states", "ssd_state_pass",
                      "ssd_chunk_outputs"),
            "attention_bwd": node_ms("_FlashBackward"),
            "ssd_bwd": node_ms("_SSDScanBackward"),
            "top": [(e.key, e.device_time_total / 1e3, e.count)
                    for e in top]}


def state_tensors(state: dict) -> dict:
    """Every tensor of a train state by name."""
    opt = state["opt"]
    out = {f"params/{n}": p for n, p in state["params"].named_parameters()}
    for part in ("mu", "nu"):
        out.update({f"opt/{part}/{n}": t for n, t in opt[part].items()})
    out["opt/step"] = opt["step"]
    return out


def train(device: str, card: str, limit_s: int) -> dict:
    """Phase 8: train zamba2-1.2b at full width (random weights from a
    seeded generator) for ``TRAIN_STEPS`` steps. Returns the phase's
    kernel launches (flash attention and SSD) on its main path, (b). Fails
    past ``limit_s`` seconds of wall clock."""
    from repro_torch.checkpoint.manager import (AsyncCheckpointer,
                                                CheckpointManager)
    from repro_torch.configs import get_config
    from repro_torch.core.engine_torch import replay as rp
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import ALL_KERNELS
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_step import (TrainConfig,
                                                 init_train_state,
                                                 make_train_step)
    time_limit(8, limit_s)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        cfg = get_config(TRAIN_ARCH)
        sites = cfg.n_layers // cfg.shared_attn_every
        opt = OptimizerConfig(peak_lr=3e-4, warmup_steps=2,
                              total_steps=TRAIN_STEPS)
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(
            cfg, opt, torch.Generator(device=device).manual_seed(0),
            device=device)
        step_fn = make_train_step(cfg, opt, TrainConfig(remat="full"))
        pipe = TokenPipeline(DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH),
                             cfg)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in state["params"].parameters())
        print(f"  {cfg.name} at full width: {n_params:,} float32 "
              f"parameters, AdamW state {TRAIN_BATCH} x {TRAIN_SEQ} tokens "
              f"a step, remat full, built in "
              f"{time.perf_counter() - t0:.2f} s")
        losses, step_ms, launches = [], [], None

        def one_step(i):
            nonlocal state
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = step_fn(state, pipe.batch_at(i))
            end.record()
            end.synchronize()
            losses.append(m["loss"].item())
            step_ms.append(start.elapsed_time(end))

        # (a) step 0 (the warm-up) with the first call of each kernel
        # captured; the call sites held against the plain versions
        with Capture(fa, "flash_attention") as attn, \
                Capture(ssd, "ssd_scan") as scan:
            one_step(0)
        site_attn = check_train_attention(attn.args, attn.kwargs)
        site_ssd = check_train_ssd(scan.args, scan.kwargs)
        # (b) every launch counter around one step, the main path's
        for mod in ALL_KERNELS.values():
            mod.launches = 0
        rp.launches = 0
        one_step(1)
        launches = {name: mod.launches for name, mod in ALL_KERNELS.items()}
        launches["budget_scan"] = rp.launches
        print(f"  (b) step 1: launches {launches}")
        want = {**{k: 0 for k in launches}, "flash_attention": sites,
                "ssd": 2 * cfg.n_layers}
        if launches != want:
            fail(f"train: one step made {launches} kernel launches, not "
                 f"{want}")
        # (d) a checkpoint after step TRAIN_SAVE_AT, written while the
        # next steps run; the state kept on the card to compare
        for i in range(2, TRAIN_SAVE_AT):
            one_step(i)
        peak = torch.cuda.max_memory_allocated() / 1e9
        ac = AsyncCheckpointer(CheckpointManager(ckpt_dir, keep=1))
        t0 = time.perf_counter()
        ac.save(TRAIN_SAVE_AT, state)
        snap_s = time.perf_counter() - t0
        kept = {n: t.detach().clone() for n, t in state_tensors(
            state).items()}
        for i in range(TRAIN_SAVE_AT, TRAIN_STEPS - 1):
            one_step(i)
        t0 = time.perf_counter()
        ac.wait()
        wait_s = time.perf_counter() - t0
        # (e) the last step under the profiler
        prof = train_profile(lambda: one_step(TRAIN_STEPS - 1))
        t0 = time.perf_counter()
        restored = ac.manager.restore(TRAIN_SAVE_AT, init_train_state(
            cfg, opt, torch.Generator(device=device).manual_seed(1),
            device=device))
        restore_s = time.perf_counter() - t0
        got = state_tensors(restored)
        differ = [n for n, t in kept.items() if not torch.equal(got[n], t)]
        size = sum(os.path.getsize(os.path.join(ckpt_dir, f))
                   for f in os.listdir(ckpt_dir)) / 1e9
        print(f"  (d) checkpoint of step {TRAIN_SAVE_AT} through "
              f"AsyncCheckpointer: {size:.3f} GB, snapshot on the caller "
              f"thread {snap_s:.2f} s, write waited for {wait_s:.2f} s after "
              f"{TRAIN_STEPS - 1 - TRAIN_SAVE_AT} more steps, restore "
              f"{restore_s:.2f} s; {len(kept) - len(differ)} of {len(kept)} "
              f"tensors bit-identical")
        if differ:
            fail(f"train: the restored checkpoint differs in {differ[:4]}")
        del kept, restored, got
        # (c) the loss
        print(f"  (c) loss by step: {[round(x, 4) for x in losses]}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            fail(f"train: the loss is not finite or did not fall: {losses}")
        # (e) measurements
        # after the warm-up and before the checkpoint; then beside its write
        clean = step_ms[1:TRAIN_SAVE_AT]
        beside = step_ms[TRAIN_SAVE_AT:TRAIN_STEPS - 1]
        med = statistics.median(clean)
        tokens = TRAIN_BATCH * TRAIN_SEQ
        print(f"  (e) [{card}] step {med:.1f} ms (CUDA events, median of "
              f"steps 1-{TRAIN_SAVE_AT - 1}, {min(clean):.1f}-"
              f"{max(clean):.1f}), {tokens / med * 1e3:.0f} tokens/s; steps "
              f"{TRAIN_SAVE_AT}-{TRAIN_STEPS - 2} beside the checkpoint's "
              f"write: median {statistics.median(beside):.1f} ms; warm-up "
              f"step {step_ms[0]:.1f} ms; peak memory {peak:.3f} GB over "
              f"steps 0-{TRAIN_SAVE_AT - 1}; each step (the last profiled): "
              f"{[round(x, 1) for x in step_ms]} ms")
        if prof is None:
            print(f"  (e) [{card}] shares of a step: not measured (the "
                  f"profiler traced no kernel)")
        else:
            whole, dev = step_ms[-1], prof["all"]
            print(f"  (e) [{card}] profiled step {whole:.1f} ms; device time "
                  f"by torch.profiler: all kernels {dev:.1f} ms "
                  f"({dev / whole:.3f} of the step, so "
                  f"{1 - dev / whole:.3f} idle) in {prof['launches']} "
                  f"launches; shares of the device time: flash attention "
                  f"{prof['attention']:.2f} ms ({prof['attention'] / dev:.4f}"
                  f"), SSD {prof['ssd']:.2f} ms ({prof['ssd'] / dev:.4f}), "
                  f"attention backward {prof['attention_bwd']:.2f} ms "
                  f"({prof['attention_bwd'] / dev:.4f}), SSD backward "
                  f"{prof['ssd_bwd']:.2f} ms ({prof['ssd_bwd'] / dev:.4f})")
            for key, ms, count in prof["top"]:
                print(f"    {ms:9.3f} ms {count:5d}x {key[:90]}")
        print(f"  (a) [{card}] call sites a step: attention forward "
              f"{sites} x {site_attn['fwd_ms']:.3f} ms, backward {sites} x "
              f"{site_attn['bwd_ms']:.3f} ms; SSD forward 2 x "
              f"{cfg.n_layers} x {site_ssd['fwd_ms']:.3f} ms, backward "
              f"{cfg.n_layers} x {site_ssd['bwd_ms']:.3f} ms")
        return {"flash_attention": launches["flash_attention"],
                "ssd": launches["ssd"]}
    finally:
        signal.alarm(0)
        shutil.rmtree(ckpt_dir, ignore_errors=True)


# ----------------------------------------------------------------- phase 9
def free_card() -> None:
    """Return the last part's memory to the card before the next."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def check_family_attention(what: str, args: tuple, kwargs: dict,
                           card: str) -> None:
    """One captured flash-attention call of a phase 9 prefill: the kernel
    against ``attention_plain`` on the card, the output within bf16's
    RTOL and each row's lse within float32's (the lse is what shows a
    lost key-length mask: the pad keys are zeros, so an unmasked kernel
    adds Skv - kv_len scores of 0 to each row's sum, which moves the
    output by about a per cent of its small spread but the lse by up to
    log(1 + 36 / 1500) at whisper's shapes, far past float32's RTOL);
    timed beside the plain version, the bound and SDPA over the real keys
    alone (the same function: the pad keys are masked), each printed."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = args
    bh, sq, d = q.shape
    skv = k.shape[1]
    kwargs = {**kwargs, "return_lse": False}
    causal, window = kwargs["causal"], kwargs["window"]
    kv_len = kwargs["kv_len"]
    plain = dict(causal=causal, window=window, kv_len=kv_len)
    call = (f"{what} {bh}x{sq}x{d} over {k.shape[0]}x{skv} (kv_len "
            f"{kv_len}) bf16 causal {causal} tiles ({kwargs['block_q']},"
            f"{kwargs['block_kv']})")
    out, lse = fa.flash_attention(q, k, v, **{**kwargs, "return_lse": True})
    out_ref, lse_ref = fa.attention_plain(q, k, v, return_lse=True, **plain)
    agree(call, out.float(), out_ref.float(), RTOL[torch.bfloat16])
    agree(f"{call}: lse", lse, lse_ref, RTOL[torch.float32])
    ms = time_ms(lambda: fa.flash_attention(q, k, v, **kwargs))
    plain_ms = time_ms(lambda: fa.attention_plain(q, k, v, **plain), reps=5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kr, vr = k[None, :, :kv_len], v[None, :, :kv_len]
    library_ms = time_ms(lambda: sdpa(q[None], kr, vr, is_causal=causal,
                                      enable_gqa=True))
    pairs = sq * (sq + 1) / 2 if causal else sq * kv_len
    ops_ms = 4.0 * bh * pairs * d / PEAK_BF16_FLOPS * 1e3
    bytes_ms = (nbytes(q, k, v) + nbytes(q)) / PEAK_BYTES * 1e3
    print(f"  [{card}] {what}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, SDPA {library_ms:.4f} ms, bound {max(ops_ms, bytes_ms):.4f} "
          f"ms (operations {ops_ms:.4f} at the bf16 rate, bytes "
          f"{bytes_ms:.4f})")


def serve_family(cfg, model, device: str, card: str, tokens, new: int,
                 max_len: int, want: int) -> int:
    """``ServingEngine.generate`` of one request a row of ``tokens``,
    ``new`` tokens each, with every launch counter set to 0 before and
    read after: exactly ``want`` flash-attention launches (the prefill's;
    decode is plain) and no other. Prints prefill ms and decode ms a token
    (CUDA events), tokens/s, peak memory and by ``torch.profiler`` the
    kernel's share of a prefill; returns the launches."""
    from repro_torch.inference.engine import (Request, ServingEngine,
                                              family_inputs)
    from repro_torch.kernels import ALL_KERNELS
    from repro_torch.models import transformer as tf
    b, plen = tokens.shape
    engine = ServingEngine(cfg, model, max_len=max_len)
    reqs = [Request(prompt=row, max_new_tokens=new)
            for row in tokens.tolist()]
    for mod in ALL_KERNELS.values():
        mod.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = engine.generate(reqs)
    wall = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in ALL_KERNELS.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"  {cfg.name}: {b} requests of {plen} tokens, {new} new each, "
          f"max_len {max_len}: launches {launches}")
    if launches != {**{k: 0 for k in launches}, "flash_attention": want}:
        fail(f"{cfg.name}: one generate made {launches} kernel launches, "
             f"not {want} flash-attention launches alone")
    if [len(o) for o in outs] != [new] * b or not all(
            0 <= x < cfg.vocab for o in outs for x in o):
        fail(f"{cfg.name}: the engine returned malformed tokens")
    t = engine.timings
    device_s = (t["prefill_ms"] + t["decode_ms"]) / 1e3
    print(f"  [{card}] {cfg.name}: prefill {t['prefill_ms']:.3f} ms; decode "
          f"{t['decode_ms'] / t['steps']:.4f} ms a token ({t['steps']} "
          f"steps of batch {b}); {b * new / device_s:.1f} tokens/s "
          f"generated over prefill + decode ({b * plen / t['prefill_ms'] * 1e3:.0f}"
          f" prompt tokens/s in prefill); host wall {wall:.3f} s; peak "
          f"memory {peak:.3f} GB")
    batch = {"tokens": tokens, **family_inputs(cfg, b, plen, device)}
    with torch.inference_mode():
        prof = device_profile(lambda: tf.prefill(cfg, model, batch, max_len))
        pre_ms = time_ms(lambda: tf.prefill(cfg, model, batch, max_len),
                         reps=5)
    if prof is None:
        print(f"  [{card}] {cfg.name}: the kernel's share of a prefill: not "
              f"measured (the profiler traced no kernel)")
    else:
        print(f"  [{card}] {cfg.name}: prefill {pre_ms:.3f} ms (CUDA events, "
              f"median of 5); device time by torch.profiler: all kernels "
              f"{prof['all']:.3f} ms ({prof['all'] / pre_ms:.3f} of the "
              f"prefill) in {prof['launches']} launches, flash attention "
              f"{prof['attention']:.3f} ms ({want} launches, "
              f"{prof['attention'] / pre_ms:.3f})")
        for key, ms, count in prof["top"][:6]:
            print(f"    {ms:9.3f} ms {count:5d}x {key[:90]}")
    return launches["flash_attention"]


def seeded_model(cfg, device: str):
    from repro_torch.models import transformer as tf
    t0 = time.perf_counter()
    model = tf.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    print(f"  {cfg.name}: {cfg.n_layers} layers"
          f"{f' + {cfg.n_encoder_layers} encoder' if cfg.n_encoder_layers else ''}"
          f", d {cfg.d_model}, {n:,} float32 parameters ({n * 4 / 1e9:.2f} "
          f"GB), built in {time.perf_counter() - t0:.2f} s")
    return model


def prompts(cfg, device: str, b: int, s: int):
    gen = torch.Generator(device=device).manual_seed(1)
    return torch.randint(0, cfg.vocab, (b, s), generator=gen, device=device)


def whisper_serve(device: str, card: str) -> int:
    """Phase 9 (a): whisper-small at full width and depth."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as tf
    cfg = get_config(WHISPER_ARCH)
    model = seeded_model(cfg, device)
    # the engine feeds zero audio, under which every encoder score is
    # equal: the kernel is held on the pipeline's audio (normal x 0.1)
    pipe = TokenPipeline(DataConfig(cfg.vocab, WHISPER_PROMPT,
                                    WHISPER_BATCH), cfg)
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in pipe.batch_at(0).items()}
    batch["tokens"] = batch["tokens"][:, :WHISPER_PROMPT].long()
    first_cross = cfg.n_encoder_layers + 1  # after layer 0's self-attention
    with Capture(fa, "flash_attention") as enc, \
            Capture(fa, "flash_attention", at=first_cross) as cross, \
            torch.inference_mode():
        tf.prefill(cfg, model, batch, WHISPER_MAX_LEN)
        full = tf.forward(cfg, model, batch)
        last, cache, n = tf.prefill(cfg, model, {
            **batch, "tokens": batch["tokens"][:, :-1]}, WHISPER_MAX_LEN)
        step, _ = tf.decode_step(cfg, model, cache, batch["tokens"][:, -1:],
                                 n)
    err_last = (last - full[:, -2]).abs().max().item()
    spread = full[:, -1].std().item() + 1e-6
    err_step = (step - full[:, -1]).abs().max().item()
    ok = (bool(torch.isfinite(full).all()) and err_last < 0.05
          and err_step / spread < 0.3)
    print(f"  (a) prefill of {WHISPER_PROMPT - 1} tokens against forward: "
          f"max |err| {err_last:.6g} (limit 0.05); one decode step: max "
          f"|err| {err_step:.6g}, {err_step / spread:.4f} of the logits' "
          f"spread (limit 0.3) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("whisper: prefill and decode disagree with forward")
    del full, cache
    with torch.inference_mode():
        check_family_attention("(a) whisper encoder attention", enc.args,
                               enc.kwargs, card)
        check_family_attention("(a) whisper cross-attention", cross.args,
                               cross.kwargs, card)
    launches = serve_family(cfg, model, device, card,
                            prompts(cfg, device, WHISPER_BATCH,
                                    WHISPER_PROMPT),
                            WHISPER_NEW, WHISPER_MAX_LEN,
                            cfg.n_encoder_layers + 2 * cfg.n_layers)
    return launches


def whisper_train(device: str, card: str) -> int:
    """Phase 9 (b): whisper-small trained for ``WHISPER_STEPS`` steps."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import ALL_KERNELS
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_step import (TrainConfig,
                                                 init_train_state,
                                                 make_train_step)
    cfg = get_config(WHISPER_ARCH)
    opt = OptimizerConfig(peak_lr=3e-4, warmup_steps=2,
                          total_steps=WHISPER_STEPS)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, opt, torch.Generator(
        device=device).manual_seed(0), device=device)
    step_fn = make_train_step(cfg, opt, TrainConfig(remat="full"))
    pipe = TokenPipeline(DataConfig(cfg.vocab, WHISPER_TRAIN_SEQ,
                                    WHISPER_BATCH), cfg)
    losses, step_ms = [], []

    def one_step(i):
        nonlocal state
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step_fn(state, pipe.batch_at(i))
        end.record()
        end.synchronize()
        losses.append(m["loss"].item())
        step_ms.append(start.elapsed_time(end))

    with Capture(fa, "flash_attention", at=cfg.n_encoder_layers + 1) as x:
        one_step(0)
    check_cross_site(x.args, x.kwargs)
    for mod in ALL_KERNELS.values():
        mod.launches = 0
    one_step(1)
    launches = {name: mod.launches for name, mod in ALL_KERNELS.items()}
    want = cfg.n_encoder_layers + 4 * cfg.n_layers  # remat full: 2 x 24
    print(f"  (b) step 1: launches {launches}")
    if launches != {**{k: 0 for k in launches}, "flash_attention": want}:
        fail(f"whisper train: one step made {launches} kernel launches, "
             f"not {want} flash-attention launches alone")
    for i in range(2, WHISPER_STEPS):
        one_step(i)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"  (b) loss by step: {[round(x, 4) for x in losses]}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"whisper train: the loss is not finite or did not fall: "
             f"{losses}")
    med = statistics.median(step_ms[1:])
    tokens = WHISPER_BATCH * WHISPER_TRAIN_SEQ
    print(f"  (b) [{card}] step {med:.1f} ms (CUDA events, median of steps "
          f"1-{WHISPER_STEPS - 1}, {min(step_ms[1:]):.1f}-"
          f"{max(step_ms[1:]):.1f}), {tokens / med * 1e3:.0f} decoder "
          f"tokens/s ({WHISPER_BATCH} x {cfg.n_audio_frames} frames a step "
          f"beside); warm-up step {step_ms[0]:.1f} ms; peak memory "
          f"{peak:.3f} GB")
    return launches["flash_attention"]


def dq_same_algorithm(q, k, v, out, dout, *, causal, window, kv_len):
    """dq of attention in float64 by the flash backward's algorithm, from
    the materialized masked softmax: dq = scale * sum_j p_j (dp_j - delta)
    k_j with delta = sum(dout * out) read from the given ``out`` (the
    forward's bf16 output, as the flash backward reads it) instead of the
    exact output autograd's softmax gradient uses. The oracle of a bf16
    dq: the rounding of ``out`` that both packages' backward share is in
    it, and nothing else of theirs."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    group = bh // k.shape[0]
    kf = torch.repeat_interleave(k, group, dim=0).double()
    vf = torch.repeat_interleave(v, group, dim=0).double()
    scale = d ** -0.5
    s = torch.einsum("hqd,hkd->hqk", q.double(), kf) * scale
    q_pos = torch.arange(sq, device=q.device)[:, None]
    kv_pos = torch.arange(skv, device=q.device)[None, :]
    mask = kv_pos < kv_len
    if causal:
        mask = mask & (q_pos >= kv_pos)
    if window is not None:
        mask = mask & ((q_pos - kv_pos) < window)
    p = torch.softmax(torch.where(mask, s, -torch.inf), dim=-1)
    dp = torch.einsum("hqd,hkd->hqk", dout.double(), vf)
    delta = (dout.double() * out.double()).sum(-1, keepdim=True)
    return torch.einsum("hqk,hkd->hqd", p * (dp - delta), kf) * scale


def check_cross_site(args: tuple, kwargs: dict) -> None:
    """The first cross-attention call of a whisper-small train step, as
    captured (bf16, the decoder's 448 tokens padded to 512 over 1,536
    keys of which 1,500 are real): the kernel's lse against the plain
    logsumexp (float32 RTOL); the ``_Flash`` Function (kernel forward,
    PyTorch backward) against autograd through ``attention_plain`` on the
    card by relative error, in float32 (the captured inputs cast, the
    kernel's float32 instantiation) and in bf16, each within its dtype's
    RTOL; bf16's dq against ``dq_same_algorithm`` instead. In bf16 the
    flash backward's delta = sum(dout * out) reads the bf16-rounded
    output (the reference's custom VJP does the same); with near-uniform
    attention over 1,500 keys that share a common component, dq cancels,
    and that rounding shows in it, in the reference's VJP as in the
    port's (tests/test_torch_training.py
    ``test_flash_backward_bf16_dq_cancels_as_the_reference``), so against
    autograd it is printed only."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention
    kw = dict(kwargs)
    kw.pop("return_lse")
    plain = dict(causal=kw["causal"], window=kw["window"],
                 kv_len=kw["kv_len"])
    what = (f"(b) train cross-attention {tuple(args[0].shape)} over "
            f"{tuple(args[1].shape)} kv_len {kw['kv_len']}")
    _, lse = fa.flash_attention(*args, return_lse=True, **kw)
    _, lse_ref = fa.attention_plain(*args, return_lse=True, **plain)
    agree(f"{what}: lse", lse, lse_ref, RTOL[torch.float32])
    gen = torch.Generator(device=args[0].device).manual_seed(8)
    dout = torch.randn(args[0].shape, generator=gen, device=args[0].device)
    for dtype in (torch.float32, torch.bfloat16):
        leaves = [t.detach().to(dtype).requires_grad_() for t in args]
        cot = dout.to(dtype)
        ours = attention._Flash.apply(*leaves, kw["block_q"], kw["block_kv"],
                                      kw["causal"], kw["window"],
                                      kw["kv_len"])
        ours = (ours, *torch.autograd.grad(ours, leaves, cot))
        ref = fa.attention_plain(*leaves, **plain)
        ref = (ref, *torch.autograd.grad(ref, leaves, cot))
        names = ("out", "dq", "dk", "dv")
        held = [i for i in range(4) if dtype == torch.float32 or i != 1]
        grads_agree(f"{what} {str(dtype)[6:]}", [names[i] for i in held],
                    [ours[i] for i in held], [ref[i] for i in held],
                    RTOL[dtype])
        if dtype == torch.bfloat16:
            print(f"  {what} bfloat16: dq against autograd (exact delta): "
                  f"relative error {rel_err(ours[1], ref[1]):.3g}")
            grads_agree(f"{what} bfloat16, delta from the bf16 output",
                        ["dq"], [ours[1]], [dq_same_algorithm(
                            *(t.detach() for t in leaves), ours[0].detach(),
                            cot, **plain)], RTOL[dtype],
                        "dq_same_algorithm")


def moe_routing(mod, x, gen) -> dict:
    """What decides the MoE's drops at one layer's input ``x`` (B, S, D):
    the share of (token, expert) choices dropped by capacity; the share
    of a token's experts that its predecessor also chose (k / E for
    independent choices); the share of the input's energy in each row's
    mean token (the component all tokens of a row share); the largest
    expert load over the capacity; and the drop share of the same router
    on the input with the row mean taken out, and on independent normal
    tokens of the input's rms."""
    cfg = mod.cfg
    _, top_e, _, keep, cap = mod.route(x)
    xf = x.float()
    mean = xf.mean(1, keepdim=True)
    load = torch.nn.functional.one_hot(top_e.flatten(1),
                                       cfg.n_experts).sum(1)
    noise = torch.randn(xf.shape, generator=gen, device=x.device)
    noise = noise * xf.pow(2).mean().sqrt()
    return {
        "dropped": (~keep).float().mean().item(),
        "neighbour_overlap": (top_e[:, 1:, :, None] == top_e[:, :-1, None, :]
                              ).any(-1).float().mean().item(),
        "common_energy": (mean.pow(2).sum(-1)[:, 0]
                          / xf.pow(2).sum(-1).mean(1)).mean().item(),
        "max_load_over_cap": load.max().item() / cap,
        "dropped_mean_removed": (~mod.route((xf - mean).to(x.dtype))[3]
                                 ).float().mean().item(),
        "dropped_iid_normal": (~mod.route(noise.to(x.dtype))[3]
                               ).float().mean().item()}


def check_moe_layer(moe, x: torch.Tensor) -> None:
    """A full-width MoE layer on the card against the same module and
    weights on the CPU, in float32 (TF32 off), on one row of the layer's
    captured prefill input (the capacity is a row's): the routes (experts
    and kept choices) equal and the output within float32's RTOL by
    relative error."""
    x = x.float()
    with torch.inference_mode():
        card = moe(x).cpu()
        route_card = [t.cpu() for t in moe.route(x)[1:4:2]]
    device = x.device
    moe.to("cpu")
    try:
        with torch.inference_mode():
            t0 = time.perf_counter()
            host = moe(x.cpu())
            host_s = time.perf_counter() - t0
            route_host = moe.route(x.cpu())[1:4:2]
    finally:
        moe.to(device)
    moved = sum(int((a != b).sum()) for a, b in zip(route_card, route_host))
    err = rel_err(card, host)
    ok = moved == 0 and err <= RTOL[torch.float32]
    print(f"  layer 0's MoE on one row of {x.shape[1]} tokens, float32, card "
          f"against CPU ({host_s:.1f} s there): {moved} route entries "
          f"differ, output relative error {err:.3g} (limit "
          f"{RTOL[torch.float32]:g}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("the MoE on the card disagrees with the same module on the CPU")


def family_serve(arch: str, device: str, card: str, layers=None) -> int:
    """Phase 9 (c) and (d): a decoder-only family served at full width
    (depth cut to ``layers`` where given), its first prefill attention
    call held against the plain version; for MoE, ``moe_routing`` at each
    layer of a prefill and ``check_moe_layer`` at layer 0."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.inference.engine import family_inputs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as tf
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = seeded_model(cfg, device)
    tokens = prompts(cfg, device, FAMILY_BATCH, FAMILY_PROMPT)
    batch = {"tokens": tokens, **family_inputs(cfg, FAMILY_BATCH,
                                               FAMILY_PROMPT, device)}
    routing, first = [], []
    gen = torch.Generator(device=device).manual_seed(2)

    def hook(mod, args, out):
        routing.append(moe_routing(mod, args[0], gen))
        if not first:
            first.append(args[0][:1].clone())

    hooks = [blk.moe.register_forward_hook(hook)
             for blk in model.layers if blk.moe is not None]
    with Capture(fa, "flash_attention") as attn, torch.inference_mode():
        tf.prefill(cfg, model, batch, FAMILY_MAX_LEN)
    for h in hooks:
        h.remove()
    if routing:
        print(f"  {cfg.name}: routing at each layer's MoE input in a prefill "
              f"(capacity factor {cfg.capacity_factor}, top {cfg.top_k} of "
              f"{cfg.n_experts}; independent choices overlap "
              f"{cfg.top_k / cfg.n_experts:.4f}):")
        for key in routing[0]:
            print(f"    {key}: {[round(r[key], 4) for r in routing]}")
        check_moe_layer(model.layers[0].moe, first[0])
    with torch.inference_mode():
        check_family_attention(f"{cfg.name} attention", attn.args,
                               attn.kwargs, card)
    return serve_family(cfg, model, device, card, tokens, FAMILY_NEW,
                        FAMILY_MAX_LEN, cfg.n_layers)


def families(device: str, card: str, limit_s: int) -> int:
    """Phase 9: the moe, audio and vlm families on the card. Returns the
    flash-attention launches of its main paths (each part's generate and
    whisper's training step 1). Fails past ``limit_s`` seconds of wall
    clock."""
    time_limit(9, limit_s)
    try:
        launches = 0
        for part, fn in (("(a) serving whisper-small", whisper_serve),
                         ("(b) training whisper-small", whisper_train),
                         ("(c) serving qwen2-vl-2b", functools.partial(
                             family_serve, VLM_ARCH)),
                         ("(d) serving qwen3-moe-235b-a22b, 4 of 94 layers",
                          functools.partial(family_serve, MOE_ARCH,
                                            layers=MOE_LAYERS))):
            t0 = time.perf_counter()
            print(f"  {part}")
            launches += fn(device, card)
            free_card()
            print(f"  [{part}: {time.perf_counter() - t0:.1f} s]")
        return launches
    finally:
        signal.alarm(0)


# ---------------------------------------------------------------- phase 10
def free_invariants(what: str, cache, out: dict, runs: int, G: int,
                    budget: "float | None") -> None:
    """tests/test_engine_jax.py's invariants of one ``free_run`` output:
    shapes, monotone curves ending at the final spend and best, spend
    equal to fresh evaluations, spend within the budget up to the one
    commit that may cross it, and every finite best a valid row holding
    that time."""
    compiled, cols = cache.space.compiled, cache.columns
    col_map = cols.rows_for_space(compiled)
    charge_max = max(float(cols.charge_s.max()),
                     cache.mean_eval_charge() if (col_map < 0).any()
                     else 0.0)
    finite = np.isfinite(out["best_value"])
    rows = out["best_row"][finite]
    valid = bool(((rows >= 0) & (rows < compiled.n_valid)).all())
    at = col_map[rows] if valid else np.array([-1])
    checks = {
        "shapes": (out["curve_spent"].shape == (runs, G)
                   and out["curve_best"].shape == (runs, G)
                   and all(out[k].shape == (runs,) for k in (
                       "best_value", "best_row", "spent_seconds",
                       "spent_evals", "fresh_evals", "exhausted"))),
        "monotone curves": bool(  # compares, not diffs: inf - inf is nan
            (out["curve_spent"][:, 1:] >= out["curve_spent"][:, :-1]).all()
            and (out["curve_best"][:, 1:]
                 <= out["curve_best"][:, :-1]).all()),
        "curves end at the outputs": bool(
            np.array_equal(out["curve_spent"][:, -1], out["spent_seconds"])
            and np.array_equal(out["curve_best"][:, -1],
                               out["best_value"])),
        "spent_evals == fresh_evals": bool(
            np.array_equal(out["spent_evals"], out["fresh_evals"])),
        "spend within the budget": budget is None or bool(
            (out["spent_seconds"] < budget + charge_max).all()),
        "finite bests are valid rows": valid and bool((at >= 0).all()),
        "best_value == time_s of best_row": valid and bool(
            (at >= 0).all()) and bool(np.array_equal(
                cols.time_s[at], out["best_value"][finite])),
        "no best, no row": bool((out["best_row"][~finite] == -1).all()),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"phase 10 {what}: invariants fail: {bad}")


def numpy_best(cache, name: str, budget: float, repeats: int) -> np.ndarray:
    """Best values of ``repeats`` runs of the numpy strategy, seeded as
    tests/test_engine_jax.py seeds them (``random.Random(1000 + i)``)."""
    from repro_torch.core.budget import Budget
    from repro_torch.core.runner import SimulationRunner
    from repro_torch.core.strategies import get_strategy
    best = []
    for i in range(repeats):
        runner = SimulationRunner(cache, Budget(max_seconds=budget),
                                  engine="numpy")
        get_strategy(name).run(cache.space, runner, random.Random(1000 + i))
        best.append(runner.best.value)
    return np.asarray(best)


def count_syncs(fn) -> int:
    """Host synchronisations of one ``fn()``: the warnings of
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def scan_profile(fn) -> tuple:
    """``(scan ms, kernels ms, kernel launches)`` of one ``fn()`` on the
    device, from ``torch.profiler``'s CUDA kernel events; None where the
    trace holds no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    if not kern:
        return None
    scan = sum(e.device_time_total for e in kern
               if "budget_scan_kernel" in e.key) / 1e3
    return (scan, sum(e.device_time_total for e in kern) / 1e3,
            sum(e.count for e in kern))


def same_outputs(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


def free_running(device: str, card: str, hot, limit_s: int) -> int:
    """Phase 10: the free-running strategies (``free_run``) on the card,
    (a)-(h) of the module docstring. Returns the budget-scan launches of
    its ``free_run`` calls. Fails past ``limit_s`` seconds of wall
    clock."""
    from unittest import mock

    from repro_torch.core.engine_torch import replay as rp
    from repro_torch.core.engine_torch import strategies as frs
    time_limit(10, limit_s)
    try:
        gemm = synthetic_gemm_cache()
        R, G, P = FREE_RUNS, FREE_GENERATIONS, FREE_POP
        budget = float(gemm.columns.charge_s.sum()) * FREE_BUDGET_SHARE
        print(f"  {card}; GEMM cache {gemm.space.compiled.n_valid} configs, "
              f"R = {R}, G = {G}, P = {P}, budget {budget:.6f} s "
              f"({FREE_BUDGET_SHARE} of the total charge)")
        launches = 0

        def run(cache, name, **kw):
            nonlocal launches
            n0 = rp.launches
            out = frs.free_run(cache, name, device=device, **kw)
            n = rp.launches - n0
            if n != kw["generations"]:
                fail(f"phase 10 {name}: {n} budget-scan launches for "
                     f"{kw['generations']} generations")
            launches += n
            return out

        for name in FREE_STRATEGIES:
            kw = {"runs": R, "seed": 0, "generations": G, "popsize": P,
                  "max_seconds": budget}
            # (a) the full-width run: wall median of 3, synchronised
            out = run(gemm, name, **kw)
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = run(gemm, name, **kw)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            wall = statistics.median(walls)
            fresh = int(out["fresh_evals"].sum())
            prof = scan_profile(lambda: run(gemm, name, **kw))
            print(f"  (a) {name}: wall {wall * 1e3:.2f} ms a call (median "
                  f"of 3; min {min(walls) * 1e3:.2f}, max "
                  f"{max(walls) * 1e3:.2f}), {fresh} fresh evaluations, "
                  f"{fresh / wall:,.0f} a second, exhausted "
                  f"{float(out['exhausted'].mean()):.4f} of runs, "
                  f"mean best {float(np.mean(out['best_value'])):.6g} s; "
                  + ("device time not measured" if prof is None else
                     f"device: scan {prof[0]:.4f} ms of {prof[1]:.4f} ms "
                     f"of kernels ({prof[0] / prof[1]:.4f}), {prof[2]} "
                     f"kernel launches, busy {prof[1] / 1e3 / wall:.4f} "
                     f"of the wall") + f" [{card}]")
            free_invariants(f"(d) {name}", gemm, out, R, G, budget)
            # (b) pinned seed
            if not same_outputs(out, run(gemm, name, **kw)):
                fail(f"phase 10 (b) {name}: a pinned seed did not "
                     f"reproduce bit for bit")
            # (c) the plain version on this path, on the card
            with mock.patch.object(frs, "budget_scan", rp.budget_scan_plain):
                n0 = rp.launches
                plain = frs.free_run(gemm, name, device=device, **kw)
                if rp.launches != n0:
                    fail("phase 10 (c): the plain run launched the kernel")
            if not same_outputs(out, plain):
                fail(f"phase 10 (c) {name}: the kernel's run differs from "
                     f"the plain version's")
            # (e) statistics against 25 numpy runs
            ref = numpy_best(gemm, name, budget, REPEATS)
            spread = float(ref.max() - ref.min()) or 1e-9
            diff = abs(float(np.mean(out["best_value"])) - float(ref.mean()))
            print(f"  (b)-(e) {name}: bit-identical to itself and to the "
                  f"plain scan; invariants hold; mean best "
                  f"{float(np.mean(out['best_value'])):.6g} against numpy "
                  f"{float(ref.mean()):.6g} over {REPEATS} runs (spread "
                  f"{spread:.6g}, |diff| {diff:.6g}, limit 3x spread)")
            if not np.isfinite(out["best_value"]).all() or diff >= 3 * spread:
                fail(f"phase 10 (e) {name}: mean best {diff:.6g} from "
                     f"numpy's, over 3x its spread {spread:.6g}")
        # the kernel at (R, P) as free_run calls it, timed alone; these
        # launches time the kernel and are not the main path's
        main_launches = rp.launches
        first = {}

        def capture(*args):
            first.setdefault("args", args)
            return rp.budget_scan(*args)

        with mock.patch.object(frs, "budget_scan", capture):
            frs.free_run(gemm, "genetic_algorithm", device=device, runs=R,
                         seed=0, generations=1, popsize=P,
                         max_seconds=budget)
        args = first["args"]
        got = rp.budget_scan(*args)
        moved = nbytes(*(a for a in args if isinstance(a, torch.Tensor)),
                       *got)
        bound = max(moved / PEAK_BYTES,
                    int(got[0].sum().item()) / PEAK_F64_FLOPS) * 1e3
        kernel_ms = kernel_device_ms(lambda: rp.budget_scan(*args),
                                     "budget_scan_kernel")
        print(f"  budget_scan {R}x{P} (a generation): kernel "
              + ("not measured" if kernel_ms is None
                 else f"{kernel_ms:.4f} ms") + f" on the device "
              f"(torch.profiler), bound {bound:.6f} ms ({moved / 1e6:.3f} "
              f"MB moved) [{card}]")
        rp.launches = main_launches
        # (f) repair and misses on phase 4's hotspot recording
        compiled = hot.space.compiled
        col_map = hot.columns.rows_for_space(compiled)
        hot_budget = float(hot.columns.charge_s.sum()) * HOT_BUDGET_SHARE
        print(f"  (f) hotspot recording: {compiled.n_valid} valid of "
              f"{compiled.cartesian_size} configs, "
              f"{int((col_map >= 0).sum())} recorded, budget "
              f"{hot_budget:.6f} s")
        for name in FREE_STRATEGIES[:3]:
            out = run(hot, name, runs=R, seed=1, generations=G, popsize=P,
                      max_seconds=hot_budget)
            free_invariants(f"(f) {name}", hot, out, R, G, hot_budget)
            print(f"  (f) {name}: invariants hold; mean fresh "
                  f"{float(out['fresh_evals'].mean()):.1f}, exhausted "
                  f"{float(out['exhausted'].mean()):.4f}, mean best "
                  f"{float(np.mean(out['best_value'])):.6g} s")
        # (g) exhaustion: random search over the whole space, no budget
        n = compiled.n_valid
        G_all = -(-n // P) + 2
        out = run(hot, "random_search", runs=FREE_EXHAUST_RUNS, seed=2,
                  generations=G_all, popsize=P)
        charge = np.where(col_map >= 0, hot.columns.charge_s[col_map],
                          hot.mean_eval_charge())
        ok = (bool((out["fresh_evals"] == n).all())
              and bool((out["best_value"] == hot.optimum).all())
              and bool(np.allclose(out["spent_seconds"], charge.sum(),
                                   rtol=1e-10, atol=0.0)))
        print(f"  (g) random search, {FREE_EXHAUST_RUNS} runs x {G_all} "
              f"generations: fresh {sorted(set(out['fresh_evals'].tolist()))} "
              f"of {n}, best {sorted(set(out['best_value'].tolist()))} (optimum "
              f"{hot.optimum}), spend {float(out['spent_seconds'][0])!r} "
              f"against {float(charge.sum())!r}")
        if not ok:
            fail("phase 10 (g): random search did not exhaust the space "
                 "exactly")
        # (h) host synchronisations of a call, at G and at 2G
        syncs = {g: count_syncs(lambda g=g: run(
            gemm, "genetic_algorithm", runs=R, seed=0, generations=g,
            popsize=P, max_seconds=budget)) for g in (G, 2 * G)}
        print(f"  (h) host synchronisations a call: {syncs[G]} at G = {G}, "
              f"{syncs[2 * G]} at G = {2 * G}")
        if syncs[G] != syncs[2 * G] or not syncs[G]:
            fail(f"phase 10 (h): synchronisations depend on the "
                 f"generations (or were not counted): {syncs}")
        return launches
    finally:
        signal.alarm(0)


# ----------------------------------------------------------------- driver
# ---------------------------------------------------------------- phase 11
def reset_launches() -> None:
    from repro_torch.core.engine_torch import replay as rp
    from repro_torch.kernels import ALL_KERNELS
    for mod in ALL_KERNELS.values():
        mod.launches = 0
    rp.launches = 0


def read_launches() -> dict:
    from repro_torch.core.engine_torch import replay as rp
    from repro_torch.kernels import ALL_KERNELS
    out = {name: mod.launches for name, mod in ALL_KERNELS.items()}
    out["budget_scan"] = rp.launches
    return out


def recorded_calls(cache) -> int:
    """Kernel calls a live recording made: one warm-up and one a repeat
    for every ok config (a refused config never launched)."""
    return sum(1 + len(r.times_s) for r in cache.results.values()
               if r.status == "ok")


def check_launches(what: str, got: dict, want: dict) -> None:
    want = {name: want.get(name, 0) for name in got}
    print(f"  {what}: launches {got}")
    if got != want:
        fail(f"phase 11 {what}: launches {got}, recordings ran {want}")


def median_us(fn, n: int) -> float:
    times = []
    for _ in range(n):
        t0 = time.perf_counter_ns()
        fn()
        times.append(time.perf_counter_ns() - t0)
    return statistics.median(times) / 1e3


def naive_best(cache):
    """The answer without the service: a scan over the cache's results
    plus the config decode (the reference's ``hub_lookup`` yardstick)."""
    best = key = None
    for k, r in cache.results.items():
        if r.status == "ok" and (best is None or r.time_s < best):
            best, key = r.time_s, k
    return cache.space.as_dict(cache.space.config_from_id(key)), best


def hub_build(root: pathlib.Path, device: str, card: str, label: str):
    """Phase 11 (a)."""
    from repro_torch.api import Hub
    from repro_torch.hub import HubError, storage
    reset_launches()
    t0 = time.perf_counter()
    hub = Hub.build(str(root), progress=print, device=device,
                    devices=HUB_MODELS)
    wall = time.perf_counter() - t0
    got = read_launches()
    try:
        hub.verify()
    except HubError as e:
        fail(f"phase 11 (a): {e}")
    files = hub.manifest["files"]
    want_keys = sorted([f"{k}@{d}" for k in ("dedispersion", "convolution",
                                              "hotspot", "gemm")
                        for d in HUB_MODELS]
                       + [f"flash_attention@{label}", f"ssd@{label}"])
    if sorted(files) != want_keys:
        fail(f"phase 11 (a): the hub holds {sorted(files)}")
    print(f"  {card}; (a) Hub.build: {len(files)} entries, every sha256 "
          f"verified, {wall:.2f} s wall (manifest build_wall_seconds "
          f"{hub.manifest['build_wall_seconds']:.2f})")
    check_launches("(a) build", got, {
        k: recorded_calls(storage.load_cache(str(root), f"{k}@{label}"))
        for k in ("flash_attention", "ssd")})
    return hub, wall


def hub_fleet(root: pathlib.Path, device: str, card: str, label: str):
    """Phase 11 (b)."""
    from repro_torch.hub import storage
    from repro_torch.kernels import HUB_KERNELS
    from repro_torch.scenarios import (ScenarioMatrix, gate_recorded,
                                       run_fleet)
    from repro_torch.service import ConfigHub
    matrix = ScenarioMatrix(kernels=tuple(HUB_KERNELS), devices=(label,))
    reset_launches()
    t0 = time.perf_counter()
    out = run_fleet(str(root), matrix=matrix, runner="live",
                    max_evals=FLEET_EVALS, repeats=FLEET_REPEATS,
                    device=device, progress=print)
    wall = time.perf_counter() - t0
    got = read_launches()
    if len(out.recorded) != 2 * len(HUB_KERNELS):
        fail(f"phase 11 (b): the fleet recorded {out.recorded}")
    files = storage.read_manifest(str(root))["files"]
    want = {}
    for key in files:
        kernel, dev, _ = storage.split_key(key)
        if dev == label and kernel in HUB_KERNELS:
            cache = storage.load_cache(str(root), key)
            want[kernel] = want.get(kernel, 0) + recorded_calls(cache)
            ok = [r.time_s for r in cache.results.values()
                  if r.status == "ok"]
            print(f"  {key}: {len(cache.results)} configs, {len(ok)} ok, "
                  f"best {min(ok) * 1e3:.4f} ms")
    print(f"  {card}; (b) run_fleet: {len(out.recorded)} scenarios recorded "
          f"live in {wall:.2f} s")
    check_launches("(b) fleet", got, want)
    again = run_fleet(str(root), matrix=matrix, runner="live",
                      max_evals=FLEET_EVALS, repeats=FLEET_REPEATS,
                      device=device)
    if again.recorded or sorted(again.skipped) != sorted(out.recorded):
        fail(f"phase 11 (b): a second fleet did not skip everything: "
             f"{again.to_json()}")
    report = matrix.coverage(ConfigHub(str(root)), with_best=True)
    tiers = [r.tier for r in report.rows]
    if tiers != ["recorded"] * len(out.recorded):
        fail(f"phase 11 (b): coverage tiers {tiers}")
    gate = gate_recorded(report.recorded_best(), report.recorded_best())
    if gate:
        fail(f"phase 11 (b): the gate failed against itself: {gate}")
    print(f"  (b) second fleet: {len(again.skipped)} skipped, 0 recorded; "
          f"coverage {report.counts()}; gate against itself passes")
    return wall


def hub_lookups(root: pathlib.Path, card: str, label: str) -> dict:
    """Phase 11 (c)."""
    from repro_torch.cli import serve_requests
    from repro_torch.hub import storage
    from repro_torch.scenarios import MODELED_CONFIDENCE, best_modeled
    from repro_torch.service import ConfigHub
    svc = ConfigHub(str(root))
    hub_size = storage.hub_default_problem("gemm")
    r = svc.lookup("gemm", None, label)
    loads = svc.disk_loads
    if r.status != "exact" or r.source != f"gemm@{label}":
        fail(f"phase 11 (c): gemm on {label}: {r.status} from {r.source}")
    if svc.lookup("gemm", hub_size, label).status != "exact" \
            or svc.disk_loads != loads:
        fail("phase 11 (c): an explicit hub size missed or touched disk")
    timings = {}
    for name, device in (("card", label), ("tpu_v5e", "tpu_v5e")):
        cache = storage.load_cache(str(root), f"gemm@{device}")
        hit = svc.lookup("gemm", None, device)
        naive_cfg, naive_val = naive_best(cache)
        if (hit.best_config, hit.best_value) != (naive_cfg, naive_val):
            fail(f"phase 11 (c): gemm@{device}: the service's best "
                 f"{hit.best_config} differs from the naive scan's "
                 f"{naive_cfg}")
        loads = svc.disk_loads
        hit_us = median_us(lambda: svc.lookup("gemm", None, device),
                           LOOKUP_HITS)
        scan_us = median_us(lambda: naive_best(cache), NAIVE_SCANS[name])
        if svc.disk_loads != loads:
            fail("phase 11 (c): warmed exact hits touched disk")
        timings[name] = (hit_us, scan_us)
        print(f"  {card}; (c) gemm@{device} ({len(cache.results)} configs):"
              f" exact hit median {hit_us:.2f} us over {LOOKUP_HITS} hits,"
              f" naive scan + decode {scan_us:.2f} us over "
              f"{NAIVE_SCANS[name]} ({scan_us / hit_us:.1f}x); disk loads "
              f"{svc.disk_loads}, flat while timed")
    t = svc.lookup("gemm", {"m": 2048}, label)
    if t.status != "transfer" or t.source != f"gemm@{label}":
        fail(f"phase 11 (c): gemm m=2048 on {label}: {t.status} from "
             f"{t.source}")
    x = svc.lookup("gemm", None, "tpu_v4")
    if x.status != "transfer" or x.confidence != 1.0 / 1.5:
        fail(f"phase 11 (c): gemm on tpu_v4: {x.status} ({x.confidence})")
    m = svc.lookup("gemm", FAR_GEMM, "tpu_v4")
    mb = best_modeled("gemm", {**hub_size, **FAR_GEMM}, "tpu_v4")
    if m.status != "modeled" or m.confidence != MODELED_CONFIDENCE or (
            m.best_config, m.best_value) != (mb.config, mb.value):
        fail(f"phase 11 (c): gemm {FAR_GEMM} on tpu_v4: {m.status}, "
             f"{m.best_config} against best_modeled's {mb.config}")
    print(f"  (c) gemm m=2048 on {label}: transfer from {t.source} "
          f"(distance {t.distance:.4f}, confidence {t.confidence:.4f}); "
          f"gemm on tpu_v4: transfer from {x.source} (confidence "
          f"{x.confidence:.4f}); gemm 32768^3 on tpu_v4: modeled "
          f"{m.best_config}, {m.best_value * 1e3:.4f} ms "
          f"({m.model['dominant']}-bound), equal to best_modeled")
    reqs = [{"kernel": "gemm", "device": label},
            {"kernel": "gemm", "problem": {"m": 2048}, "device": label},
            {"kernel": "gemm", "problem": FAR_GEMM, "device": "tpu_v4"},
            {"kernel": "no_such_kernel", "device": label}]
    answers = list(serve_requests(svc, [json.dumps(reqs)]))
    statuses = [a.get("status") for a in answers]
    if statuses != ["exact", "transfer", "modeled", "cold"]:
        fail(f"phase 11 (c): serve_requests answered {answers}")
    print(f"  (c) serve_requests: one array line of {len(reqs)} requests "
          f"-> {statuses}; lookups {svc.stats()['lookups']}")
    return timings


def hub_warm_start(root2: pathlib.Path, device: str, card: str,
                   label: str) -> None:
    """Phase 11 (d)."""
    from repro_torch.hub import storage
    from repro_torch.service import ConfigHub
    storage.write_manifest(str(root2), storage.new_manifest())
    svc = ConfigHub(str(root2), warm_start={"max_evals": WARM_EVALS,
                                            "device": device})
    reset_launches()
    t0 = time.perf_counter()
    r = svc.lookup("dedispersion", None, label)
    if r.status != "warming":
        fail(f"phase 11 (d): a cold dedispersion lookup answered "
             f"{r.status}")
    flight = svc.warm_start.ensure("dedispersion", label, r.problem)
    if not flight.join(120.0) or flight.error is not None:
        fail(f"phase 11 (d): the warm-start flight failed: {flight.error}")
    wall = time.perf_counter() - t0
    got = read_launches()
    r2 = svc.lookup("dedispersion", None, label)
    if r2.status != "exact" or svc.warm_start.launches != 1:
        fail(f"phase 11 (d): after the flight: {r2.status}, "
             f"{svc.warm_start.launches} flights")
    cache = storage.load_cache(str(root2), r2.source)
    print(f"  {card}; (d) warm start: warming (confidence "
          f"{r.confidence:.3f}), the flight recorded {len(cache.results)} "
          f"configs live in {wall:.2f} s, then exact from {r2.source} "
          f"({r2.best_value * 1e3:.4f} ms)")
    check_launches("(d) warm start", got,
                   {"dedispersion": recorded_calls(cache)})


def hub_scoring(root: pathlib.Path, device: str, card: str) -> int:
    """Phase 11 (e); returns its budget-scan launches."""
    from repro_torch.api import Tuner
    with Tuner(hub_root=str(root), engine="vectorized",
               repeats=HUB_SCORE_REPEATS, device=device) as numpy_tuner:
        ends_check([s.cache for s in numpy_tuner.scorers])
        t0 = time.perf_counter()
        numpy_run = numpy_tuner.simulate("genetic_algorithm")
        numpy_wall = time.perf_counter() - t0
    reset_launches()
    with Tuner(hub_root=str(root), repeats=HUB_SCORE_REPEATS,
               device=device) as tuner:
        t0 = time.perf_counter()
        run = tuner.simulate("genetic_algorithm")
        torch_wall = time.perf_counter() - t0
    got = read_launches()
    if run.score != numpy_run.score or run.report.per_space_score != \
            numpy_run.report.per_space_score:
        fail(f"phase 11 (e): torch engine {run.report.per_space_score} "
             f"against numpy {numpy_run.report.per_space_score}")
    if not got["budget_scan"] or any(n for k, n in got.items()
                                     if k != "budget_scan"):
        fail(f"phase 11 (e): launches {got}")
    print(f"  {card}; (e) Tuner(hub_root).simulate GA x "
          f"{HUB_SCORE_REPEATS} over {sorted(run.report.per_space_score)}:"
          f" score {run.score!r} on both engines, bit-identical; torch "
          f"{torch_wall:.2f} s (drive {run.fuse}), numpy {numpy_wall:.2f} "
          f"s; budget-scan launches {got['budget_scan']}")
    return got["budget_scan"]


def hub_verbs(root: pathlib.Path, device: str, card: str,
              label: str) -> None:
    """Phase 11 (f)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    cov = root / "coverage.json"
    cases = [
        (["hub", "verify", "--root", str(root)], 0),
        (["lookup", "--hub-root", str(root), "--kernel", "gemm",
          "--device", label, "--json"], 0),
        (["lookup", "--hub-root", str(root), "--kernel", "no_such_kernel",
          "--device", label], 3),
        (["scenarios", "--hub-root", str(root), "--device", device,
          "--out", str(cov)], 0),
        (["scenarios", "--hub-root", str(root), "--device", device,
          "--gate", str(cov)], 0),
    ]
    for argv, want in cases:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "repro_torch", *argv],
                              env=env, cwd=ROOT, capture_output=True,
                              text=True, timeout=120)
        wall = time.perf_counter() - t0
        tail = (proc.stdout.strip().splitlines() or [""])[-1]
        shown = " ".join(a.replace(str(root), "<root>") for a in argv)
        print(f"  (f) repro_torch {shown}: exit {proc.returncode} in "
              f"{wall:.2f} s: {tail[:160]}")
        if proc.returncode != want:
            fail(f"phase 11 (f): {argv} exited {proc.returncode}, not "
                 f"{want}: {proc.stderr[-2000:]}")
        if argv[0] == "lookup" and want == 0 and \
                json.loads(proc.stdout)["status"] != "exact":
            fail(f"phase 11 (f): lookup answered {proc.stdout}")
    print(f"  {card}; (f) the verbs as subprocesses: all exits as expected")


def hub_phase(device: str, card: str, limit_s: int) -> dict:
    """Phase 11: the hub, the lookup service and the scenario layer on the
    card, (a)-(f) of the module docstring. Returns the launches of its
    main paths. Fails past ``limit_s`` seconds of wall clock."""
    from repro_torch.cuda import device_label
    label = device_label(device)
    base = ROOT / "chiprun_out"
    base.mkdir(exist_ok=True)
    root = pathlib.Path(tempfile.mkdtemp(prefix="hub-", dir=base))
    root2 = pathlib.Path(tempfile.mkdtemp(prefix="hub-warm-", dir=base))
    time_limit(11, limit_s)
    launches = {}

    def add(got: dict) -> None:
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n

    try:
        print(f"  {card}; label {label}; roots {root.name}, {root2.name}")
        hub_build(root, device, card, label)
        add(read_launches())
        hub_fleet(root, device, card, label)
        add(read_launches())
        hub_lookups(root, card, label)
        hub_warm_start(root2, device, card, label)
        add(read_launches())
        hub_scoring(root, device, card)
        add(read_launches())
        hub_verbs(root, device, card, label)
    finally:
        signal.alarm(0)
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(root2, ignore_errors=True)
    return launches


def flat_tree(tree: dict, prefix: str = "") -> dict:
    """A nested dict's leaves by 'a/b' path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def one_rank_mesh(device: str) -> dict:
    """Phase 12 (a): zamba2-1.2b served and differentiated on a real
    one-rank mesh against the same calls unsharded, same weights.
    Returns the sharded calls' kernel launches."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.distribution import annotate as an
    from repro_torch.distribution import sharding as sh
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd
    from repro_torch.launch.mesh import destroy_world, make_host_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.training.train_step import TrainConfig, make_loss_fn
    cfg = get_config(SERVE_ARCH)
    store = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    dist.init_process_group("nccl" if device != "cpu" else "gloo",
                            init_method=f"file://{store}/pg", rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh(device)
        model = seeded_model(cfg, device)
        tokens = prompts(cfg, device, SERVE_BATCH,
                         SERVE_PROMPT + MESH_DECODE_STEPS)
        train_tokens = prompts(cfg, device, TRAIN_BATCH, TRAIN_SEQ + 1)
        loss_fn = make_loss_fn(cfg, TrainConfig(remat="full"))
        names = [n for n, _ in model.named_parameters()]

        def run(sharded: bool) -> tuple:
            """(logits, cache, loss, grads, launches) of the calls."""
            def place(t):
                if not sharded:
                    return t
                return sh.distribute_tree({"t": t}, mesh, sh.batch_shardings(
                    mesh, {"t": t}))["t"]

            def whole(t):
                return t.full_tensor() if sharded else t

            before = (fa.launches, ssd.launches)
            logits = []
            with torch.no_grad():
                last, cache, n = tf.prefill(
                    cfg, model, {"tokens": place(tokens[:, :SERVE_PROMPT])},
                    SERVE_MAX_LEN)
                logits.append(whole(last))
                for i in range(MESH_DECODE_STEPS):
                    at = SERVE_PROMPT + i
                    step, cache = tf.decode_step(
                        cfg, model, cache, place(tokens[:, at:at + 1]),
                        n + i)
                    logits.append(whole(step))
            loss = loss_fn(model, {"tokens": place(train_tokens)})
            grads = torch.autograd.grad(loss, list(model.parameters()))
            torch.cuda.synchronize()
            made = (fa.launches - before[0], ssd.launches - before[1])
            cache = {k: whole(v) for k, v in flat_tree(cache).items()}
            return (logits, cache, whole(loss).detach(),
                    [whole(g) for g in grads], made)

        t0 = time.perf_counter()
        plain = run(False)
        plain_s = time.perf_counter() - t0
        sh.distribute_model(model, mesh)
        t0 = time.perf_counter()
        with an.annotation_mesh(mesh), implicit_replication():
            sharded = run(True)
        sharded_s = time.perf_counter() - t0
        diffs = {
            "logits": max((a - b).abs().max().item()
                          for a, b in zip(plain[0], sharded[0])),
            "cache": max((plain[1][k].float() - sharded[1][k].float()
                          ).abs().max().item() for k in plain[1]),
            "loss": (plain[2] - sharded[2]).abs().item(),
            "grads": max((a - b).abs().max().item()
                         for a, b in zip(plain[3], sharded[3]))}
        same = (all(torch.equal(a, b) for a, b in zip(plain[0], sharded[0]))
                and all(torch.equal(plain[1][k], sharded[1][k])
                        for k in plain[1])
                and torch.equal(plain[2], sharded[2])
                and all(torch.equal(a, b)
                        for a, b in zip(plain[3], sharded[3])))
        print(f"  (a) {cfg.name} on a one-rank mesh "
              f"{tuple(mesh.mesh_dim_names)} {tuple(mesh.shape)}: a "
              f"{SERVE_BATCH} x {SERVE_PROMPT} prefill, "
              f"{MESH_DECODE_STEPS} decode steps, the loss and "
              f"{len(names)} gradients at {TRAIN_BATCH} x {TRAIN_SEQ}: "
              f"plain {plain_s:.2f} s, DTensor {sharded_s:.2f} s; max "
              f"|diff| {diffs}; launches plain {plain[4]}, sharded "
              f"{sharded[4]}; loss {plain[2].item():.6f} "
              f"{'bit-identical' if same else 'MISMATCH'}")
        if not same:
            fail(f"phase 12 (a): the one-rank mesh differs from the plain "
                 f"calls: {diffs}")
        if plain[4] != sharded[4] or not all(plain[4]):
            fail(f"phase 12 (a): launches plain {plain[4]}, sharded "
                 f"{sharded[4]}")
        return {"flash_attention": sharded[4][0], "ssd": sharded[4][1]}
    finally:
        destroy_world()
        shutil.rmtree(store, ignore_errors=True)


def mesh_phase(device: str, card: str, limit_s: int) -> dict:
    """Phase 12: (b) and (c) start in a pool of spawned processes (each a
    fake world of 512 ranks), (a) runs here meanwhile; every worker is
    stopped at the end. Returns (a)'s launches."""
    import concurrent.futures as cf
    import multiprocessing as mproc
    from repro_torch.autotune import perf
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import init_fake_world
    time_limit(12, limit_s)
    t_phase = time.perf_counter()
    pool = cf.ProcessPoolExecutor(
        DRYRUN_WORKERS, mp_context=mproc.get_context("spawn"),
        initializer=init_fake_world, initargs=(512,))
    try:
        cells = [(a, s, m) for a, s in DRYRUN_CELLS
                 for m in ("single", "multi")]
        arch, shape, mesh_kind, evals = HILLCLIMB
        climb = pool.submit(
            perf.hillclimb, arch, shape, mesh_kind, max_evals=evals,
            out_dir=str(ROOT / "build" / "chip_smoke" / "perf"),
            hbm_budget=torch.cuda.get_device_properties(0).total_memory,
            device=device)
        futures = [pool.submit(dryrun.run_cell, *c, device=device)
                   for c in cells]
        launches = one_rank_mesh(device)
        print(f"  (b) fake-world dry run, {len(cells)} cells in "
              f"{DRYRUN_WORKERS} processes ({card}):")
        bad = []
        for (a, s, m), f in zip(cells, futures):
            rec = f.result()
            if rec["status"] != "ok":
                bad.append((a, s, m))
                print(f"      {a:20s} {s:12s} {m:6s} {rec['status'].upper()}"
                      f" {rec.get('error', rec.get('reason'))}\n"
                      f"{rec.get('traceback', '')}")
                continue
            r, mem = rec["roofline"], rec["memory"]
            coll = rec["collectives"]["counts"]
            print(f"      {a:20s} {s:12s} {m:6s} ok  dominant "
                  f"{r['dominant']:10s} useful {r['useful_ratio']:.4f} "
                  f"peak {mem['peak_bytes_per_chip'] / 2**30:.2f} GiB a rank"
                  f", flops {rec['cost']['hlo_flops_per_chip']:.4g} a rank"
                  f" (analytic {rec['cost']['analytic_flops_per_chip']:.4g})"
                  f", collectives {coll}, {rec['local_ops']} local ops, "
                  f"traced in {rec['compile_s']} s")
        if bad:
            fail(f"phase 12 (b): dry-run cells not ok: {bad}")
        res = climb.result()
        print(f"  (c) hillclimb {arch} {shape} {mesh_kind}, {evals} "
              f"evaluations: baseline {res['baseline']}, best "
              f"{res['best']}, improvement {res['improvement']}")
        for e in res["evaluations"]:
            print(f"      {e}")
        if res["improvement"] is None:
            fail("phase 12 (c): the hillclimb found no feasible config")
        print(f"  [phase 12 (a)-(c): {time.perf_counter() - t_phase:.1f} s]")
        return launches
    finally:
        signal.alarm(0)
        for proc in list(getattr(pool, "_processes", {}).values()):
            proc.terminate()
        pool.shutdown(wait=True, cancel_futures=True)


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
    latency_build = start_latency_build()
    secs = cuda.build()
    print(f"  built {sorted(secs)} in {time.perf_counter() - t0:.2f} s "
          f"(per kernel: {secs})")
    for name in sorted(secs):
        for line in cuda.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    check_sass(cuda.library_path("gemm"))
    check_dedisp_build(cuda.build_log("dedispersion"))
    check_conv_build(cuda.build_log("convolution"))
    check_hotspot_build(cuda.build_log("hotspot"))
    check_attention_build(cuda.build_log("flash_attention"))
    check_ssd_build(cuda.build_log("ssd"))

    print("[3] kernels against their plain versions")
    kernels = [check_gemm(device, GEMM_SHAPES, HUB), check_conv(device),
               check_hotspot(device), check_dedisp(device),
               check_attention(device), check_ssd(device),
               check_scan(device, SCAN_RUNS, latency_build)]

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    reset_launches()
    print("[4] main path: live recordings of the four hub kernels at their "
          "hub sizes and of the two framework kernels at full model width")
    caches, paths = {}, {}
    for name in HUB_PROBLEMS:
        t0 = time.perf_counter()
        caches[name], paths[name] = record(
            out_dir, device, name, HUB_PROBLEMS[name], RECORD_EVALS[name],
            RECORD_SECONDS[name])
        print(f"  [{name}: {time.perf_counter() - t0:.1f} s]")
    from repro_torch.core.cache import CacheFile
    loaded = [CacheFile.load(str(paths[name])) for name in caches]
    print("[5] main path: replay and scoring")
    t0 = time.perf_counter()
    ends_check(loaded)
    time_limit(5, SCORE_LIMIT_S)
    try:
        left_out = cap_guard(loaded, REPEATS)
        split = {f"{name}, phase 5": n for name, n in replay_and_score(
            caches["gemm"], paths["gemm"], device, SCAN_RUNS, REPEATS,
            left_out).items()}
        for name, n in score_both_engines(loaded, device, REPEATS,
                                          left_out).items():
            key = f"{name}, phase 5"
            split[key] = split.get(key, 0) + n
    finally:
        signal.alarm(0)
    print(f"  [phase 5: {time.perf_counter() - t0:.1f} s]")
    print(f"[6] main path: exhaustive GA hypertuning across the "
          f"{len(loaded)} recordings")
    t0 = time.perf_counter()
    split["genetic_algorithm, phase 6 campaigns"] = hypertune(
        loaded, device, HYPERTUNE_REPEATS, HYPERTUNE_LIMIT_S)
    print(f"  [phase 6 GA campaigns: {time.perf_counter() - t0:.1f} s]")
    split["dual_annealing meta campaign, phase 6"] = meta_campaign(
        loaded, device, HYPERTUNE_REPEATS, out_dir,
        max(1, HYPERTUNE_LIMIT_S - int(time.perf_counter() - t0)))
    print(f"  [phase 6: {time.perf_counter() - t0:.1f} s]")
    launches = read_launches()
    print(f"  launches on the main path of phases 4-6: {launches}")
    print(f"  budget-scan launches of phases 5-6 by strategy: {split}")
    if not all(launches.values()):
        fail(f"a kernel of the main path never launched: {launches}")
    print(f"[7] main path: serving {SERVE_ARCH} at full width, "
          f"{SERVE_BATCH} requests of {SERVE_PROMPT} tokens")
    t0 = time.perf_counter()
    served = serve(device, smi.stdout.strip(), SERVE_LIMIT_S)
    print(f"  [phase 7: {time.perf_counter() - t0:.1f} s]")
    for name, n in served.items():
        launches[name] += n
    print(f"[8] main path: training {TRAIN_ARCH} at full width, "
          f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens")
    t0 = time.perf_counter()
    trained = train(device, smi.stdout.strip(), TRAIN_LIMIT_S)
    print(f"  [phase 8: {time.perf_counter() - t0:.1f} s]")
    for name, n in trained.items():
        launches[name] += n
    print(f"[9] main path: the moe, audio and vlm families at full width: "
          f"{WHISPER_ARCH} served and trained, {VLM_ARCH} served, "
          f"{MOE_ARCH} served at {MOE_LAYERS} layers")
    t0 = time.perf_counter()
    launches["flash_attention"] += families(device, smi.stdout.strip(),
                                            FAMILY_LIMIT_S)
    print(f"  [phase 9: {time.perf_counter() - t0:.1f} s]")
    print(f"[10] main path: free-running {', '.join(FREE_STRATEGIES)} on "
          f"the card, {FREE_RUNS} runs x {FREE_GENERATIONS} generations")
    t0 = time.perf_counter()
    reset_launches()
    # the recording as phase 4 made it, over the hub's whole space (a
    # cache loaded from its file knows only the recorded configs)
    free_launches = free_running(device, smi.stdout.strip(),
                                 caches["hotspot"], FREE_RUN_LIMIT_S)
    phase10 = read_launches()
    print(f"  launches in phase 10: {phase10}")
    if rp.launches != free_launches or any(
            n for name, n in phase10.items() if name != "budget_scan"):
        fail(f"phase 10 launched other than its free_run calls' budget "
             f"scans ({free_launches}): {phase10}")
    launches["budget_scan"] += rp.launches
    print(f"  [phase 10: {time.perf_counter() - t0:.1f} s]")
    print("[11] main path: the FAIR hub, the ConfigHub lookup service and "
          "the scenario layer on the card")
    t0 = time.perf_counter()
    phase11 = hub_phase(device, smi.stdout.strip(), HUB_LIMIT_S)
    print(f"  launches in phase 11: {phase11}")
    if not all(phase11.values()):
        fail(f"a kernel of phase 11's main path never launched: {phase11}")
    for name, n in phase11.items():
        launches[name] += n
    print(f"  [phase 11: {time.perf_counter() - t0:.1f} s]")
    print("[12] main path: the mesh tooling: a one-rank DTensor mesh on "
          "the card, the fake-world dry run, the distribution hillclimb")
    t0 = time.perf_counter()
    reset_launches()
    phase12 = mesh_phase(device, smi.stdout.strip(), MESH_LIMIT_S)
    after = read_launches()
    # the plain calls (the comparison) and the sharded ones launch alike
    if {k: v for k, v in after.items() if v} != {
            k: 2 * v for k, v in phase12.items()}:
        fail(f"phase 12 launched other than its plain and sharded calls "
             f"({phase12} each): {after}")
    for name, n in phase12.items():
        launches[name] += n
    print(f"  [phase 12: {time.perf_counter() - t0:.1f} s]")
    print(f"  launches on the main paths (phases 4-6, 7, 8, 9, 10, 11 and "
          f"12): {launches}")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(f"  {smi.stdout.strip()}; total {time.perf_counter() - t_start:.1f}"
          f" s")
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

"""One run of one cell of the port's benchmark.

A run:

  1. reads ``BENCHMARK.json`` and the cell's files by name: the
     workload ``portbench/workloads/<cell>.json`` and the configuration
     file that ``BENCHMARK.json`` names; it stops, printing no result,
     when the card or the cards the cell asks for are missing;
  2. builds the entry the workload names (``portbench/drivers/
     <driver>.py``) and lets it set up and warm up on a seed outside the
     measured ones; ``setup_s`` runs from the start of the process to the
     end of the warm-up;
  3. makes whole calls back to back until ``--seconds`` have passed, call
     k on seed ``1_000_003 * seed + k``; with ``--trace 1`` the first
     ``TRACE_CALLS`` calls run under ``torch.profiler``;
  4. after the window reads the memory peak, frees the program's state,
     and has the driver judge ``CHECK_CALLS`` of the calls, drawn from
     the seed, against the plain reference; a run that judged no call
     is not correct;
  5. refuses to print a result if JAX, Flax or the JAX package was
     loaded; else prints the metrics of the cell, each read by its own
     file (``end_to_end/<metric>.py`` with ``--trace 0``,
     ``metrics/<metric>.py`` with ``--trace 1``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import math
import pathlib
import random
import sys
import time

PKG = pathlib.Path(__file__).resolve().parent
CALL_SEED_STRIDE = 1_000_003
WARM_CALL = 1_000_002      # the index of the warm-up call's seed
CHECK_CALLS = 2            # calls of the window the reference judges
TRACE_CALLS = 3            # calls of a --trace 1 window under the profiler
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class CellError(Exception):
    """The cell's files are missing or disagree with BENCHMARK.json."""


def call_seed(seed: int, k: int) -> int:
    return CALL_SEED_STRIDE * int(seed) + k


def load_module(path: pathlib.Path, name: str):
    """A reader or driver file, loaded by its path."""
    if not path.is_file():
        raise CellError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{path.parent.name}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A cell as BENCHMARK.json and its own files give it."""

    name: str
    chips: int
    config: dict
    workload: dict
    end_to_end: list
    per_layer: list


def load_cell(root: pathlib.Path, name: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise CellError(f"no cell {name!r} in BENCHMARK.json; cells: "
                        f"{sorted(cells)}")
    entry = cells[name]
    workload = json.loads((PKG / "workloads" / f"{name}.json").read_text())
    for key in ("config", "traffic"):
        if workload.get(key) != entry[key]:
            raise CellError(f"{name}: the workload file's {key} "
                            f"{workload.get(key)!r} is not BENCHMARK.json's "
                            f"{entry[key]!r}")
    files = {c["name"]: c["file"] for c in bench["configs"]}
    config = json.loads((root / files[entry["config"]]).read_text())

    def mine(metric):
        return "workloads" not in metric or name in metric["workloads"]

    # every end-to-end reader is asked, and reads only where the call's
    # work is its unit (the driver's work_unit); the cells that an entry
    # lists are what BENCHMARK.json declares of the same, and a test
    # holds the two equal
    return Cell(name, int(entry["chips"]), config, workload,
                list(bench["end_to_end"]),
                [m for m in bench["per_layer"] if mine(m)])


def chips_present(need: int) -> "str | None":
    """Why the cards are not there, or None when they are."""
    import torch
    if not torch.cuda.is_available():
        return "no CUDA device is available"
    if torch.cuda.device_count() < need:
        return (f"the cell needs {need} cards, "
                f"{torch.cuda.device_count()} are visible")
    return None


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    the benchmark must never load."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


class Reservoir:
    """``k`` of the window's calls, drawn uniformly from the seed
    whatever their number (algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items = k, random.Random(seed), []

    def offer(self, i: int, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = self.rng.randrange(i + 1)
        if j < self.k:
            self.items[j] = item


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    setup_s: float
    calls: list                 # (start_s, end_s, work) a call, host clock
    facts: dict                 # the driver's work_unit and shapes
    memory_peak_bytes: int
    trace: "object | None" = None   # trace.Summary of a --trace 1 run


def within(value, limit: dict) -> bool:
    """``limit``: {"at_most": v} or {"at_least": v}."""
    return all(value <= v if side == "at_most" else value >= v
               for side, v in limit.items())


def read_metrics(run: Run, metrics: list, folder: str) -> dict:
    out = {}
    for m in metrics:
        value = load_module(PKG / folder / f"{m['name']}.py",
                            m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str, t0: float, root: pathlib.Path) -> dict:
    """Set up, measure, judge; the result line as a dict."""
    import torch

    from . import trace as tracing
    wl = cell.workload
    driver = load_module(PKG / "drivers" / f"{wl['driver']}.py",
                         wl["driver"]).Driver(cell.config, wl, device, root)
    t_driver = time.perf_counter()
    driver.setup(call_seed(seed, WARM_CALL))
    setup_s = time.perf_counter() - t0
    print(f"portbench: set-up {setup_s:.3f} s: before the driver "
          f"{t_driver - t0:.3f} s, "
          + ", ".join(f"{k} {v:.3f} s" for k, v in driver.timings.items()),
          file=sys.stderr)
    tracer = tracing.Tracer(TRACE_CALLS) if trace else None
    if tracer:
        tracer.start()
    kept = Reservoir(CHECK_CALLS, seed)
    calls = []
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        k = len(calls)
        s = time.perf_counter()
        with tracer.around() if tracer else contextlib.nullcontext():
            out, work = driver.call(call_seed(seed, k))
        calls.append((s, time.perf_counter(), work))
        kept.offer(k, (call_seed(seed, k), out))
    if tracer:
        tracer.stop()
    on_card = device != "cpu"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    facts = driver.facts()
    driver.free()
    t_check = time.perf_counter()
    readings = driver.check(kept.items)
    print(f"portbench: {len(calls)} calls; the check of "
          f"{len(kept.items)} took {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    limits = driver.limits()
    correct = bool(kept.items) and all(within(readings[k], limits[k])
                                       for k in limits)
    run = Run(setup_s, calls, facts, peak,
              tracer.summary() if tracer else None)
    metrics = (read_metrics(run, cell.per_layer, "metrics") if trace
               else read_metrics(run, cell.end_to_end, "end_to_end"))
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(calls), "failed": 0,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {k: {"value": readings[k], **limits[k]}
                        for k in limits}
    return result


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not (math.isfinite(args.seconds) and args.seconds > 0):
        p.error("--seconds must be a positive number")
    return args


def main(argv, root: pathlib.Path, t0: float) -> int:
    args = parse(argv)
    cell = load_cell(root, args.workload)
    why = chips_present(cell.chips)
    if why is not None:
        print(f"portbench: {why}; no result", file=sys.stderr)
        return 2
    import torch
    torch.set_num_threads(1)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", t0, root)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        limit = ", ".join(f"{k.replace('_', ' ')} {v!r}"
                          for k, v in c.items() if k != "value")
        print(f"check {name}: {c['value']!r} ({limit})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0

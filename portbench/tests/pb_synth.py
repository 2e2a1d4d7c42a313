"""Small synthetic recordings and cells for the benchmark's CPU tests."""
from __future__ import annotations

import gzip
import json
import pathlib

import numpy as np

from portbench import harness
from portbench.reference import budget_rule
from portbench.reference.recording import Recording, sha256_of

HOT_SMALL = {"h": 64, "w": 128}       # 328 valid configs of the hotspot space


def write_recording(path: pathlib.Path, kernel: str, problem: dict,
                    seed: int = 0, fail: float = 0.2,
                    drop: int = 0) -> pathlib.Path:
    """A T4-mini file over the port's space of ``kernel`` at ``problem``:
    every valid config with a seeded time, a share of them failures; the
    last ``drop`` configs left out."""
    from repro_torch.kernels import get_kernel
    space = get_kernel(kernel).space(problem)
    rng = np.random.default_rng(seed)
    configs = space.valid_configs[:len(space.valid_configs) - drop]
    results = {}
    for conf in configs:
        t = float(np.exp(rng.normal(-6.0, 1.0)))
        if rng.random() < fail:
            results[space.config_id(conf)] = {
                "status": "error", "time_s": None, "times_s": [],
                "compile_s": float(rng.random()) * 1e-4, "overhead_s": 0.0}
        else:
            results[space.config_id(conf)] = {
                "status": "ok", "time_s": t, "times_s": [t * 0.9, t, t * 1.1],
                "compile_s": t * 2.0, "overhead_s": 0.0}
    doc = {"format": "T4-mini", "format_version": "1.0", "kernel": kernel,
           "device": "synthetic", "objective": "time_s",
           "tunables": {t.name: list(t.values) for t in space.tunables},
           "constraints": [], "meta": {"problem": dict(problem)},
           "results": results}
    path.write_bytes(gzip.compress(json.dumps(doc).encode()))
    return path


def config_for(root: pathlib.Path, rel: str, kernel: str,
               problem: dict) -> dict:
    rec = Recording.load(str(root / rel))
    return {"name": "synthetic", "kernel": kernel, "problem": problem,
            "recording": rel, "sha256": sha256_of(str(root / rel)),
            "budget_s": budget_rule.budget_seconds(
                rec.kernel, rec.device, rec.time_s, rec.charge_s)}


def cell(root: pathlib.Path, strategy: str, runs: int = 8,
         generations: int = 12, kernel: str = "hotspot",
         problem: "dict | None" = None, **hyperparams) -> harness.Cell:
    """A cell over a synthetic recording under ``root``."""
    problem = HOT_SMALL if problem is None else problem
    rel = f"rec-{kernel}.json.gz"
    if not (root / rel).exists():
        write_recording(root / rel, kernel, problem)
    wl = {"config": "synthetic", "traffic": strategy, "driver": "free_run",
          "strategy": strategy, "hyperparams": hyperparams, "runs": runs,
          "generations": generations}
    e2e = [{"name": n, "unit": u} for n, u in (
        ("sim_evals_per_s", "evals/s"), ("call_p90_ms", "ms"),
        ("setup_s", "s"))]
    return harness.Cell("synthetic." + strategy, 1,
                        config_for(root, rel, kernel, problem), wl, e2e, [])

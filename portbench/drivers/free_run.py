"""Driver of free-running tuning campaigns on the card.

Each call of the window is one call of the port's entry
``repro_torch.core.engine_torch.free_run(cache, strategy, runs=R,
seed=..., generations=G, max_seconds=budget, **hyperparams)``: R
independent campaigns of one population strategy over a recorded space,
each with the configuration's per-run budget of simulated seconds. A
call's work is the fresh simulated evaluations its runs committed.

Set-up checks the frozen recording's sha256 against the configuration
file, loads it over the port's own search space of the kernel, and
refuses to go on where that space lists other configs than the
recording: a changed space definition must not change the yardstick
unseen. The check follows ``CHECK_RUNS`` runs of each sampled call,
drawn from the call's seed, with the plain reference
(``reference/free_run_ref.py``) on tables it derives itself from the
same file, and compares each one's trajectory and spend exactly.
"""
from __future__ import annotations

import gc
import pathlib
import time

import numpy as np

from portbench.reference import compare
from portbench.reference.recording import Recording, sha256_of

SCAN_KERNEL = "budget_scan_kernel"
CHECK_RUNS = 512          # runs of a sampled call the reference follows
WORK_UNIT = "sim_evals"


class SpaceMismatch(RuntimeError):
    """The port's space of the kernel is not the recorded one."""


class Driver:
    def __init__(self, config: dict, workload: dict, device: str,
                 root: pathlib.Path):
        self.config, self.workload, self.device = config, workload, device
        self.path = root / config["recording"]
        self.runs = int(workload["runs"])
        self.generations = int(workload["generations"])
        self.strategy = workload["strategy"]
        self.hyperparams = dict(workload.get("hyperparams", {}))
        self.budget_s = float(config["budget_s"])
        self.cache = None
        self.timings = {}

    def setup(self, warm_seed: int) -> None:
        """Check, load and warm up; ``self.timings`` holds the seconds of
        each part."""
        t0 = time.perf_counter()
        if sha256_of(self.path) != self.config["sha256"]:
            raise SpaceMismatch(f"{self.path}: sha256 is not the "
                                f"configuration file's")
        from repro_torch.core.cache import CacheFile
        from repro_torch.core.engine_torch import free_run
        from repro_torch.kernels import get_kernel
        t1 = time.perf_counter()
        space = get_kernel(self.config["kernel"]).space(
            self.config["problem"])
        cache = CacheFile.load(str(self.path), space=space)
        t2 = time.perf_counter()
        ids = space.compiled.ids
        if len(ids) != len(cache.results) or set(ids) != set(cache.results):
            missing = len(set(cache.results) - set(ids))
            extra = len(set(ids) - set(cache.results))
            raise SpaceMismatch(
                f"the port's {self.config['kernel']} space lists "
                f"{len(ids)} configs, the recording {len(cache.results)}: "
                f"{missing} recorded configs are not in the space and "
                f"{extra} configs of the space were not recorded")
        self.cache, self._free_run = cache, free_run
        t3 = time.perf_counter()
        self.call(warm_seed)
        self.timings = {"import": t1 - t0, "load": t2 - t1,
                        "compile": t3 - t2,
                        "warm_call": time.perf_counter() - t3}

    def call(self, seed: int) -> tuple:
        out = self._free_run(self.cache, self.strategy, runs=self.runs,
                             seed=seed, generations=self.generations,
                             max_seconds=self.budget_s, device=self.device,
                             **self.hyperparams)
        return out, int(out["fresh_evals"].sum())

    def facts(self) -> dict:
        return {"work_unit": WORK_UNIT,
                "runs": self.runs, "generations": self.generations,
                "popsize": int(self.hyperparams.get("popsize", 20)),
                "n_valid": self.cache.space.compiled.n_valid,
                "scan_kernel": SCAN_KERNEL}

    def free(self) -> None:
        self.cache = self._free_run = None
        gc.collect()
        if self.device != "cpu":
            import torch
            torch.cuda.empty_cache()

    def limits(self) -> dict:
        return dict(compare.LIMITS)

    def pick(self, seed: int):
        """The runs of call ``seed`` that the check follows, drawn from
        that seed."""
        rng = np.random.default_rng(seed % (1 << 64))
        k = min(CHECK_RUNS, self.runs)
        return np.sort(rng.choice(self.runs, size=k, replace=False))

    def reference(self, seeds, spend_dtype=np.float64) -> list:
        """The plain reference's outputs for the sampled runs of the
        calls ``seeds``; its draws on this device."""
        from portbench.reference import free_run_ref as ref
        rec = Recording.load(str(self.path))
        return [ref.free_run(rec, self.strategy, runs=self.runs, seed=seed,
                             pick=self.pick(seed),
                             generations=self.generations,
                             max_seconds=self.budget_s, device=self.device,
                             spend_dtype=spend_dtype, **self.hyperparams)
                for seed in seeds]

    def check(self, kept: list) -> dict:
        """``kept``: (seed, outputs) of the sampled calls."""
        want = self.reference([seed for seed, _ in kept])
        return compare.merge([compare.compare(got, w)
                              for (_, got), w in zip(kept, want)])

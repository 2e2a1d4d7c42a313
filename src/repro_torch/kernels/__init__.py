"""Kernel registry of the port: hand-written Hopper kernels with tunable tilings.

Port of ``src/repro/kernels/__init__.py``, with the same ``KernelSpec``
contract (``space``, ``workload``, ``make_live``, ``SMOKE_PROBLEM``). Each
module provides a wrapper that launches its CUDA kernel for tensors on the
card and takes its plain PyTorch version for tensors on the CPU, a tunable
``space()``, the analytic ``workload()`` of the cost model, and a recording
contract (``SMOKE_PROBLEM`` + ``make_live``) that turns the kernel into a
live objective the recorder (``core.record``) can measure.

Every kernel of the reference is registered, in its tiers: the four
benchmark-hub kernels of the paper (``HUB_KERNELS``: dedispersion,
convolution, hotspot, GEMM) and the framework's own hot spots
(``FRAMEWORK_KERNELS``: flash attention, Mamba2 SSD). The tiers only say
where a kernel comes from; the recording pipeline treats all six alike.
"""
from __future__ import annotations

import dataclasses
import inspect
from types import ModuleType
from typing import Callable, Mapping

from ..core.costmodel import KernelWorkload
from ..core.searchspace import SearchSpace
from . import (convolution, dedispersion, flash_attention, gemm, hotspot,
               ssd)

# registry used by the recording pipeline
HUB_KERNELS = {
    "dedispersion": dedispersion,
    "convolution": convolution,
    "hotspot": hotspot,
    "gemm": gemm,
}

FRAMEWORK_KERNELS = {
    "flash_attention": flash_attention,
    "ssd": ssd,
}

ALL_KERNELS = {**HUB_KERNELS, **FRAMEWORK_KERNELS}


def _accepted(fn: Callable, problem: Mapping) -> dict:
    """Restrict a problem dict to the keyword arguments ``fn`` declares —
    problem dicts carry the union of space/workload/input sizes."""
    params = inspect.signature(fn).parameters
    return {k: v for k, v in problem.items() if k in params}


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Registry view of one kernel module for the recording pipeline.

    ``problem`` dicts override the module's ``SMOKE_PROBLEM``; constraints
    that depend on problem sizes adapt because the module's ``space()`` is
    re-invoked with the resolved sizes.
    """

    name: str
    module: ModuleType
    tier: str  # "hub" | "framework"

    def problem(self, overrides: Mapping | None = None) -> dict:
        return {**self.module.SMOKE_PROBLEM, **(overrides or {})}

    def space(self, problem: Mapping | None = None) -> SearchSpace:
        p = self.problem(problem)
        return self.module.space(**_accepted(self.module.space, p))

    def workload(self, problem: Mapping | None = None) -> KernelWorkload:
        p = self.problem(problem)
        return self.module.workload(**_accepted(self.module.workload, p))

    def make_live(self, problem: Mapping | None = None,
                  device: str | None = None) -> Callable:
        """``fn(config_dict)`` over fixed inputs on ``device`` (the card
        unless ``"cpu"``), for a ``LiveRunner``. Built inside the worker
        that uses it (the closure holds device tensors)."""
        return self.module.make_live(self.problem(problem), device=device)


KERNELS: dict[str, KernelSpec] = {
    name: KernelSpec(name, mod,
                     "hub" if name in HUB_KERNELS else "framework")
    for name, mod in ALL_KERNELS.items()
}


def get_kernel(name: str) -> KernelSpec:
    try:
        return KERNELS[name]
    except KeyError:
        raise KeyError(
            f"unknown kernel {name!r}; registered: {sorted(KERNELS)}")

"""Roofline surrogate: price any registered kernel config analytically.

The hub answers from *measurements* where they exist; this module answers
where they don't. ``price`` derives the classic roofline terms from the
kernel's declared workload — FLOPs, HBM bytes, VMEM footprint, grid size,
and an occupancy/efficiency factor, all functions of the config's tunables
(``repro.kernels.<kernel>.workload``) — and combines them through the same
``roofline()`` machinery the launch-time analysis uses
(``roofline/analysis.py``), normalized to the requested device model.

Unlike ``costmodel.estimate`` (the *synthetic* data generator behind the
brute-forced hub: lognormal observation noise, an overlap term, 32 fake
repeats), the surrogate is a pure deterministic bound: ``max(compute_s,
memory_s)`` plus a per-grid-cell launch cost, one observation, no noise.
Pricing the same config twice returns a bit-identical ``CachedResult`` —
the property the ``modeled`` lookup tier and the conformance tests pin.

For workloads that were actually traced, ``facts_from_compiled`` reads
the dry run's counts (via ``launch.dryrun.cost_analysis_dict``) and
``price_from_facts`` turns those FLOP/byte counts into the same roofline
bound — the calibration path for non-registry workloads.

Port of ``src/repro/scenarios/surrogate.py``, a copy: ``price``,
``price_from_facts``, ``SurrogateRunner`` and ``best_modeled`` give the
reference's results bit for bit on the same inputs, and the roofline
constants stay the reference's TPU v5e frame (``roofline/analysis.py``).
Change: ``facts_from_compiled`` takes the port's dry-run record (a
``launch.dryrun.Traced``: one rank's counted FLOPs and bytes) where the
reference takes a jax ``Compiled``.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

from ..core.budget import Budget
from ..core.cache import CachedResult
from ..core.costmodel import KernelWorkload
from ..core.devices import DEVICES_BY_NAME, DeviceModel
from ..core.runner import Runner
from ..core.searchspace import SearchSpace
from ..roofline.analysis import HBM_BW, PEAK_FLOPS, Roofline, roofline

INVALID = float("inf")

# provenance tag carried by every modeled answer
MODEL_NAME = "roofline-v1"

# confidence of a modeled answer: above the cold floor (0.0) and above a
# far-shape/cross-device transfer, below any near-shape donor. A transfer
# whose ``transfer_confidence`` falls under this value yields to the
# surrogate in ``service.hub`` — see docs/scenarios.md for the calibration
# (same-device donors keep winning out to shape distance ~2.3).
MODELED_CONFIDENCE = 0.3

# per-grid-cell launch/dispatch cost; deliberately a plain constant (no
# noise, no overlap modeling) so the surrogate stays a deterministic bound
GRID_LAUNCH_S = 120e-9

# floor for the declared compute efficiency: a pathological workload factor
# must degrade the estimate, not divide by zero
MIN_EFF = 1e-3


@dataclasses.dataclass(frozen=True)
class SurrogatePrice:
    """One priced config: the roofline decomposition plus the scalar bound."""

    status: str               # "ok" | "error"
    time_s: float             # the bound (inf when infeasible)
    roofline: Roofline | None  # per-device compute/memory split, dominant
    eff: float = 0.0          # occupancy/efficiency factor used
    reason: str = ""          # error provenance ("vmem overflow")


def price(workload: KernelWorkload, config: Mapping,
          device: DeviceModel) -> SurrogatePrice:
    """Deterministic roofline bound for one config dict on one device.

    The shared ``roofline()`` combiner is written against the v5e module
    constants, so the workload terms are normalized into that frame first
    (``flops * PEAK/device.peak``): the returned seconds are then exact for
    ``device``. Collectives are zero — registry kernels are single-chip.
    """
    if workload.vmem_bytes(config) > device.vmem_bytes:
        return SurrogatePrice("error", INVALID, None, reason="vmem overflow")
    eff = min(max(workload.compute_eff(config, device), MIN_EFF), 1.0)
    flops = workload.flops(config)
    hbm = workload.hbm_bytes(config, device)
    rf = roofline(
        flops_per_chip=flops / eff * (PEAK_FLOPS / device.peak_flops),
        bytes_per_chip=hbm * (HBM_BW / device.hbm_bw),
        collective_wire_bytes=0.0, n_chips=1, mflops=flops)
    t = (max(rf.compute_s, rf.memory_s)
         + workload.grid_size(config) * GRID_LAUNCH_S)
    return SurrogatePrice("ok", t, rf, eff=eff)


def price_from_facts(facts: Mapping, device: DeviceModel,
                     eff: float = 1.0) -> SurrogatePrice:
    """Roofline bound from compile-only XLA cost-analysis facts
    (``{"flops": ..., "bytes accessed": ...}``) instead of an analytic
    workload — the ``facts_from_compiled`` calibration path."""
    flops = float(facts.get("flops", 0.0))
    hbm = float(facts.get("bytes accessed", facts.get("bytes_accessed", 0.0)))
    eff = min(max(eff, MIN_EFF), 1.0)
    rf = roofline(
        flops_per_chip=flops / eff * (PEAK_FLOPS / device.peak_flops),
        bytes_per_chip=hbm * (HBM_BW / device.hbm_bw),
        collective_wire_bytes=0.0, n_chips=1, mflops=flops)
    return SurrogatePrice("ok", max(rf.compute_s, rf.memory_s), rf, eff=eff)


def facts_from_compiled(traced) -> dict:
    """Dry-run facts of a traced cell (``launch.dryrun.lower_cell``'s
    ``Traced``): ``{"flops": ..., "bytes accessed": ...}`` per rank,
    through ``launch.dryrun.cost_analysis_dict``."""
    from ..launch.dryrun import cost_analysis_dict
    return dict(cost_analysis_dict(traced))


class SurrogateRunner(Runner):
    """A ``Runner`` whose evaluations are surrogate prices.

    Drop-in wherever a ``SimulationRunner``/``CostModelRunner`` fits: the
    base-class memo/budget/trace machinery makes it a conforming
    ``BatchRunner``, so all registered strategies (and ``drive_many``)
    tune modeled scenarios unchanged. The budget is charged the modeled
    kernel time plus device overhead — no compile term, because the
    surrogate never compiles anything.
    """

    def __init__(self, space: SearchSpace, workload: KernelWorkload,
                 device: DeviceModel, budget: Budget):
        super().__init__(space, budget)
        self.workload = workload
        self.device = device

    def _evaluate(self, config) -> CachedResult:
        p = price(self.workload, self.space.as_dict(config), self.device)
        if p.status != "ok":
            return CachedResult("error", INVALID, (), 0.0,
                                self.device.overhead_s)
        return CachedResult("ok", p.time_s, (p.time_s,), 0.0,
                            self.device.overhead_s)


@dataclasses.dataclass(frozen=True)
class ModeledBest:
    """Argmin of the surrogate over a kernel's valid space — what the
    ``modeled`` lookup tier serves (and caches) per (kernel, device,
    problem) triple."""

    kernel: str
    device: str
    problem: dict
    config: dict
    value: float
    n_ok: int                 # feasible (priced-ok) configs
    n_valid: int              # valid configs considered
    dominant: str             # roofline term of the winner
    model: str = MODEL_NAME

    def provenance(self) -> dict:
        return {"model": self.model, "device_model": self.device,
                "dominant": self.dominant, "n_ok": self.n_ok,
                "n_valid": self.n_valid}


def best_modeled(kernel: str, problem: Mapping | None,
                 device: str | DeviceModel) -> ModeledBest | None:
    """Price the kernel's whole valid space and return the deterministic
    argmin (enumeration-order tie-break), or None when the kernel/device
    is not modelable or nothing is feasible.

    Problem dicts resolve through the registry convention (overrides of
    the kernel's ``SMOKE_PROBLEM``), the same resolution every recording
    uses — so a modeled answer and a later recording of the same triple
    price/measure the same workload.
    """
    from ..kernels import KERNELS
    spec = KERNELS.get(kernel)
    if spec is None:
        return None
    if isinstance(device, DeviceModel):
        dev = device
    else:
        dev = DEVICES_BY_NAME.get(device)
        if dev is None:
            return None
    problem = dict(problem or {})
    space = spec.space(problem)
    workload = spec.workload(problem)
    best_cfg, best_val, best_dom, n_ok = None, INVALID, "", 0
    n_valid = 0
    for config in space.valid_configs:
        n_valid += 1
        p = price(workload, space.as_dict(config), dev)
        if p.status != "ok":
            continue
        n_ok += 1
        if p.time_s < best_val:
            best_cfg, best_val = config, p.time_s
            best_dom = p.roofline.dominant
    if best_cfg is None:
        return None
    return ModeledBest(kernel=kernel, device=dev.name,
                       problem=spec.problem(problem),
                       config=space.as_dict(best_cfg), value=best_val,
                       n_ok=n_ok, n_valid=n_valid, dominant=best_dom)

"""Scenario subsystem: every (kernel, shape, device) triple answerable.

Port of ``src/repro/scenarios/__init__.py``. Three pieces
(docs/scenarios.md):

* ``matrix`` — ``ScenarioMatrix``, the registry of (kernel × problem
  shape × device) triples with per-triple provenance
  (``recorded | modeled | cold``) and the recorded best-time gate; its
  live row is the label of the device the port's kernels run on;
* ``surrogate`` — the deterministic roofline pricing model,
  ``SurrogateRunner`` (a strategy-compatible ``BatchRunner``), and
  ``best_modeled`` (the argmin the hub's ``modeled`` lookup tier serves);
* ``fleet`` — the journaled recording campaign that walks the matrix and
  registers results into the hub.

``facts_from_compiled`` reads the port's dry run (``launch.dryrun``)
where the reference reads jax's compile-only cost analysis.
"""
from .fleet import FleetOutcome, run_fleet, runnable
from .matrix import (CoverageReport, CoverageRow, Scenario, ScenarioMatrix,
                     gate_recorded, kernel_shapes, live_device_label)
from .surrogate import (MODEL_NAME, MODELED_CONFIDENCE, ModeledBest,
                        SurrogatePrice, SurrogateRunner, best_modeled,
                        facts_from_compiled, price, price_from_facts)

__all__ = [
    "CoverageReport", "CoverageRow", "FleetOutcome", "MODELED_CONFIDENCE",
    "MODEL_NAME", "ModeledBest", "Scenario", "ScenarioMatrix",
    "SurrogatePrice", "SurrogateRunner", "best_modeled",
    "facts_from_compiled", "gate_recorded",
    "kernel_shapes", "live_device_label", "price", "price_from_facts",
    "run_fleet", "runnable",
]

"""The scenario matrix: every (kernel × problem shape × device) triple.

The hub's promise after this subsystem is totality: any triple in the
matrix is answerable — from a *recorded* cache where one exists, from the
*roofline surrogate* where the kernel and device are modelable, and only
otherwise ``cold``. ``ScenarioMatrix`` is the registry of triples (the
``RooflineModel.kernels()``-style enumeration ROADMAP item 5 asks for);
``coverage`` classifies each triple against a live ``ConfigHub`` and is
what `python -m repro scenarios` prints, what the fleet consumes as its
work list, and what CI archives as the coverage artifact.

Shapes per kernel are the two canonical ones every other layer already
agrees on:

* ``default`` — the kernel's hub-default problem (the ``space()``
  signature defaults ``build_hub`` brute-forced; what ``lookup`` resolves
  a bare request to);
* ``smoke`` — the kernel's ``SMOKE_PROBLEM`` (what interpret-mode CI
  recordings run), when it differs from the default.

Device rows are the six hub device models plus the live device's label
(the row live recordings land on: the card's name, or ``cpu`` when the
caller asks for the CPU).

``gate_recorded`` turns two coverage reports into a best-time regression
check, mirroring how ``benchmarks/check_regression.py`` gates evals/sec:
a recorded triple whose best time drifts above baseline × (1 + threshold)
fails, and a triple that *disappears* from the recorded tier fails too.

Port of ``src/repro/scenarios/matrix.py``. Change: the reference's live
row is the constant ``INTERPRET_DEVICE = "cpu_interpret"`` (Pallas'
interpret mode on the host); the port's is the label of the device its
kernels run on, ``live_device_label(device)``, resolved through
``cuda.resolve_device`` (the card unless ``"cpu"``; raises without CUDA),
never by probing. ``ScenarioMatrix`` takes that ``device`` for its
default rows.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from ..core.devices import DEVICES_BY_NAME, HUB_DEVICES
from ..cuda import device_label, resolve_device
from ..hub.storage import entry_key, hub_default_problem, problem_key

SHAPE_LABELS = ("default", "smoke")
TIERS = ("recorded", "modeled", "cold")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One (kernel, problem shape, device) triple. ``problem`` is the
    *resolved* shape as sorted (name, value) pairs — hashable, and equal
    exactly when the hub would treat the shapes as the same entry."""

    kernel: str
    device: str
    shape: str                 # "default" | "smoke" (display label)
    problem: tuple             # sorted ((name, value), ...) pairs

    @property
    def problem_dict(self) -> dict:
        return dict(self.problem)

    @property
    def pkey(self) -> str:
        return problem_key(self.problem_dict)

    @property
    def key(self) -> str:
        """Stable identity string — the hub entry key this triple maps to
        (``kernel@device#pkey``); also the gate/journal key."""
        return entry_key(self.kernel, self.device, self.pkey)

    def to_json(self) -> dict:
        return {"kernel": self.kernel, "device": self.device,
                "shape": self.shape, "problem": self.problem_dict,
                "key": self.key}


def live_device_label(device: str | None = None) -> str:
    """The live row: the label of the device the port's kernels run on
    (the card's name unless ``device`` is ``"cpu"``). Not a
    ``DeviceModel``, so never modelable — recorded or cold only."""
    return device_label(resolve_device(device))


def kernel_shapes(kernel: str) -> dict:
    """The canonical shapes of one kernel: ``default`` always, ``smoke``
    when it resolves to a different hub entry."""
    from ..kernels import KERNELS
    spec = KERNELS[kernel]
    default = dict(hub_default_problem(kernel))
    shapes = {"default": default}
    smoke = dict(spec.problem({}))
    # smoke resolves through the same default-merge every lookup applies
    resolved = {**default, **smoke}
    if problem_key(resolved) != problem_key(default):
        shapes["smoke"] = resolved
    return shapes


class ScenarioMatrix:
    """Deterministic enumeration of the scenario triples.

    Order is registry order × shape-label order × device order (hub
    device models first, then the live device's label) — stable across
    processes, so journals, coverage artifacts, and gate baselines key
    by position-independent ``Scenario.key`` but *print* identically.
    ``device`` (the card unless ``"cpu"``) names the live row when
    ``devices`` is not given.
    """

    def __init__(self, kernels: Sequence[str] | None = None,
                 devices: Sequence[str] | None = None,
                 shapes: Sequence[str] = SHAPE_LABELS,
                 device: str | None = None):
        from ..kernels import KERNELS
        self.kernels = tuple(kernels or KERNELS)
        unknown = [k for k in self.kernels if k not in KERNELS]
        if unknown:
            raise ValueError(f"unknown kernels: {unknown}")
        self.devices = tuple(devices if devices is not None else
                             [d.name for d in HUB_DEVICES]
                             + [live_device_label(device)])
        self.shapes = tuple(shapes)

    def scenarios(self) -> list[Scenario]:
        out = []
        for kernel in self.kernels:
            shapes = kernel_shapes(kernel)
            for label in self.shapes:
                problem = shapes.get(label)
                if problem is None:
                    continue
                pairs = tuple(sorted(problem.items()))
                for device in self.devices:
                    out.append(Scenario(kernel, device, label, pairs))
        return out

    def __len__(self) -> int:
        return len(self.scenarios())

    def __iter__(self):
        return iter(self.scenarios())

    # ---------------------------------------------------------- coverage
    def coverage(self, hub=None, with_best: bool = False) -> "CoverageReport":
        """Classify every triple: ``recorded`` when the hub holds a
        measured entry for it, ``modeled`` when the surrogate can price
        it (registry kernel on a known device model), else ``cold``.

        ``with_best`` additionally resolves each answerable triple's best
        time through ``hub.lookup`` (exact for recorded, surrogate argmin
        for modeled) — what the CLI report and the regression gate use.
        """
        recorded = hub.recorded_keys() if hub is not None else frozenset()
        rows = []
        for sc in self.scenarios():
            if (sc.kernel, sc.device, sc.pkey) in recorded:
                tier = "recorded"
            elif sc.device in DEVICES_BY_NAME:
                tier = "modeled"
            else:
                tier = "cold"
            best = status = None
            if with_best and tier != "cold" and hub is not None:
                r = hub.lookup(sc.kernel, sc.problem_dict, sc.device)
                status = r.status
                if r.found:
                    best = r.best_value
            rows.append(CoverageRow(sc, tier, best, status))
        return CoverageReport(tuple(rows))


@dataclasses.dataclass(frozen=True)
class CoverageRow:
    scenario: Scenario
    tier: str                       # recorded | modeled | cold
    best_value: float | None = None  # filled by coverage(with_best=True)
    status: str | None = None        # the lookup status actually served

    def to_json(self) -> dict:
        d = self.scenario.to_json()
        d.update(tier=self.tier, best_value=self.best_value,
                 status=self.status)
        return d


@dataclasses.dataclass(frozen=True)
class CoverageReport:
    rows: tuple

    def counts(self) -> dict:
        c = {t: 0 for t in TIERS}
        for r in self.rows:
            c[r.tier] += 1
        return c

    def matrix(self) -> dict:
        """kernels × devices counts per tier — the `hub stats` coverage
        matrix shape: {kernel: {device: {tier: n}}}."""
        out: dict = {}
        for r in self.rows:
            cell = (out.setdefault(r.scenario.kernel, {})
                    .setdefault(r.scenario.device, {t: 0 for t in TIERS}))
            cell[r.tier] += 1
        return out

    def recorded_best(self) -> dict:
        """{scenario key: best seconds} over recorded rows with a value —
        the gate baseline payload."""
        return {r.scenario.key: r.best_value for r in self.rows
                if r.tier == "recorded" and r.best_value is not None}

    def to_json(self) -> dict:
        return {"format": "repro-scenario-coverage-v1",
                "counts": self.counts(), "matrix": self.matrix(),
                "rows": [r.to_json() for r in self.rows]}


def gate_recorded(current: Mapping, baseline: Mapping,
                  threshold: float = 0.2) -> list[str]:
    """Compare recorded best times against a baseline the way
    ``check_regression`` gates evals/sec: every baseline triple must still
    be recorded, and its best time must not regress past
    ``baseline × (1 + threshold)``. Returns failure lines (empty = pass);
    triples recorded now but absent from the baseline pass (new coverage
    is an improvement, the next baseline refresh picks them up)."""
    failures = []
    for key in sorted(baseline):
        base = baseline[key]
        cur = current.get(key)
        if cur is None:
            failures.append(f"{key}: was recorded in baseline, now absent")
        elif base > 0 and cur > base * (1.0 + threshold):
            failures.append(
                f"{key}: best {cur:.3e}s vs baseline {base:.3e}s "
                f"(+{(cur / base - 1.0) * 100:.1f}% > {threshold * 100:.0f}%)")
    return failures

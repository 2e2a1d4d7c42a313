"""The recording fleet: run the scenario matrix as a resumable campaign.

ROADMAP item 5's "continuous recording fleet": walk a ``ScenarioMatrix``
work list, record each triple (the same sharded, crash-safe
``Tuner.record`` machinery behind ``python -m repro record``), merge, and
``register`` the result into the hub — turning ``modeled``/``cold``
coverage cells into ``recorded`` ones.

Resume is two-layered, matching the repo's journal conventions:

* *within* a scenario, the observation shards under
  ``<hub>/.fleet/<key>/`` resume like any interrupted recording;
* *across* scenarios, a ``CampaignJournal`` at
  ``<hub>/.fleet/journal.jsonl`` marks each registered triple, so a
  re-run (same hub root) skips straight past completed work — the CI
  smoke job and a laptop sweep share one idempotent entry point.

Scenario selection: by default everything in the matrix that the chosen
runner can actually execute — ``live`` records only on the live device's
label (the card's name, or ``cpu``); ``costmodel``/``surrogate`` record
only on hub device models. Triples already ``recorded`` in the hub are
skipped before any work starts.

Port of ``src/repro/scenarios/fleet.py``. Change: ``run_fleet`` and
``runnable`` take the port's ``device`` (the card unless ``"cpu"``):
a ``live`` fleet records through the port's kernels on that device, and
its runnable rows are that device's label, where the reference's were
``cpu_interpret``.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Callable, Sequence

from ..core.devices import DEVICES_BY_NAME
from ..core.parallel import CampaignJournal
from .matrix import Scenario, ScenarioMatrix, live_device_label

FLEET_FORMAT = "repro-fleet-journal-v1"
FLEET_DIR = ".fleet"


@dataclasses.dataclass(frozen=True)
class FleetOutcome:
    """One sweep's summary (JSON-friendly via ``to_json``)."""

    recorded: tuple          # scenario keys recorded+registered this run
    skipped: tuple           # already journaled (previous runs)
    covered: tuple           # already recorded in the hub, never journaled
    unrunnable: tuple        # runner can't execute these device rows

    def to_json(self) -> dict:
        return {"recorded": list(self.recorded),
                "skipped": list(self.skipped),
                "covered": list(self.covered),
                "unrunnable": list(self.unrunnable)}


def runnable(scenario: Scenario, runner: str,
             device: str | None = None) -> bool:
    """Can this runner actually execute this device row? ``live`` times
    the port's kernels on ``device`` (the card unless ``"cpu"``), so only
    that device's label is runnable; the model-backed runners need a
    device model to price against."""
    if runner == "live":
        return scenario.device == live_device_label(device)
    return scenario.device in DEVICES_BY_NAME


def _slug(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.@-]+", "_", key)


def run_fleet(hub_root: str,
              matrix: ScenarioMatrix | None = None,
              scenarios: Sequence[Scenario] | None = None,
              runner: str = "costmodel",
              strategy: str = "random_search",
              max_evals: int | None = 64,
              repeats: int = 3,
              workers: int = 1,
              backend: str = "serial",
              seed: int = 0,
              progress: Callable | None = None,
              device: str | None = None) -> FleetOutcome:
    """Record-and-register every runnable, not-yet-recorded scenario.

    Interrupt at any point and call again with the same ``hub_root``:
    journaled scenarios are skipped, the in-flight one resumes from its
    shards. Raises (via ``CampaignJournal.ensure_header``) if the journal
    at this root was written by a fleet with different recording settings
    — mixed-methodology hubs are exactly what the journal exists to
    prevent. ``device`` is where a ``live`` fleet records (the card
    unless ``"cpu"``); ``matrix`` defaults to the full matrix with that
    device's live row.
    """
    from ..api import Hub, Tuner

    say = progress or (lambda msg: None)
    work = list(scenarios if scenarios is not None
                else (matrix or ScenarioMatrix(device=device)).scenarios())
    hub = Hub(hub_root)
    service = hub.service()
    already = service.recorded_keys()

    fleet_dir = os.path.join(hub_root, FLEET_DIR)
    journal = CampaignJournal(os.path.join(fleet_dir, "journal.jsonl"),
                              fmt=FLEET_FORMAT)
    header = {"hub_root": os.path.abspath(hub_root), "runner": runner,
              "strategy": strategy, "max_evals": max_evals,
              "repeats": repeats, "seed": seed}
    done = {rec["key"] for rec in journal.ensure_header(header)}

    recorded, skipped, covered, unrunnable = [], [], [], []
    tuner = Tuner(hub_root=hub_root, repeats=repeats, seed=seed,
                  workers=workers, backend=backend, device=device)
    live = live_device_label(device) if runner == "live" else None
    try:
        for sc in work:
            if not (sc.device == live if live is not None
                    else runnable(sc, runner)):
                unrunnable.append(sc.key)
                continue
            if sc.key in done:
                skipped.append(sc.key)
                continue
            if (sc.kernel, sc.device, sc.pkey) in already:
                covered.append(sc.key)
                continue
            say(f"fleet: recording {sc.key} [{runner}]")
            out = os.path.join(fleet_dir, _slug(sc.key), "cache.json.gz")
            run = tuner.record(sc.kernel, runner=runner, device=sc.device,
                               problem=sc.problem_dict, strategy=strategy,
                               repeats=repeats, max_evals=max_evals,
                               out=out)
            entry = hub.register(run.cache, problem=sc.problem_dict)
            journal.append({"key": sc.key, "entry": entry,
                            "kernel": sc.kernel, "device": sc.device,
                            "problem": sc.problem_dict,
                            "best_value": run.best_value,
                            "n_evaluated": run.n_evaluated})
            recorded.append(sc.key)
            say(f"fleet: registered {entry} "
                f"(best {run.best_value!r}, {run.n_evaluated} evals)")
    finally:
        tuner.close()
    return FleetOutcome(tuple(recorded), tuple(skipped), tuple(covered),
                        tuple(unrunnable))

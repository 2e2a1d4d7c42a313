"""Single-flight warm-start campaigns for cold ConfigHub keys.

A *cold* key — a kernel with nothing recorded anywhere in the hub — cannot
be answered from data. With warm-start enabled, the service launches a
journaled recording campaign for the key **exactly once** (single-flight:
every concurrent lookup of the same cold key joins the one in-flight
campaign) and serves the incumbent best as observations stream into the
campaign's crash-safe shards.

The campaign is ``Tuner.record``: against the cost-model runner for a
key on a device model, and live through the port's kernel for a key on
the live device's label (the card's name, or ``cpu``) — the same
``CampaignJournal``-backed ``ObservationShard`` machinery as
``python -m repro_torch record``, so a killed
service resumes the recording instead of re-measuring, and the journal is
the single-flight token across restarts too. On completion the merged
cache is registered into the hub (``storage.register_cache``) and live
indexes are invalidated; the next lookup is an exact hit.

Port of ``src/repro/service/warmstart.py``. Changes: ``runner`` defaults
to None, which picks the runner by key (the cost model for a device
model, ``live`` for anything else), and ``device`` names where a live
flight runs (the card unless ``"cpu"``). A live flight can only record
the device it runs on, so ``can_serve`` holds for a live key only when
the key's device is that device's label; a card's flight records on the
flight's background thread while lookups go on.
"""
from __future__ import annotations

import os
import threading
from typing import Mapping

from ..core import record as rec
from ..cuda import device_label, resolve_device
from ..hub import storage

# incumbent confidence saturates with recorded ok-observations: 8 ok configs
# -> 0.5, full completion reported by the exact path at 1.0 afterwards
CONFIDENCE_SCALE = 8.0


class WarmStartFlight:
    """One in-flight (or finished) warm-start campaign for a cold key."""

    def __init__(self, kernel: str, device: str, problem: dict,
                 prefix: str, n_workers: int):
        self.kernel = kernel
        self.device = device
        self.problem = problem
        self.prefix = prefix
        self.n_workers = n_workers
        self.done = threading.Event()
        self.error: BaseException | None = None
        self._space = None

    def join(self, timeout: float | None = None) -> bool:
        """Block until the campaign finishes; True when done."""
        return self.done.wait(timeout)

    def incumbent(self) -> tuple[dict | None, float | None, int]:
        """Best (config, value, n_ok) observed so far, read from the
        campaign's journal shards — safe while workers are appending
        (torn trailing lines are skipped by the shard reader)."""
        paths = [p for p in (rec.shard_path(self.prefix, w)
                             for w in range(self.n_workers))
                 if os.path.exists(p)]
        best_cfg, best_val, n_ok = None, None, 0
        if self._space is None:
            self._space = rec.registry_space(self.kernel, self.problem)
        for path in paths:
            try:
                _, results = rec.ObservationShard(path).read()
            except (OSError, ValueError):
                continue
            for cid, r in results.items():
                if r.status != "ok":
                    continue
                n_ok += 1
                if best_val is None or r.time_s < best_val:
                    best_val = r.time_s
                    best_cfg = self._space.as_dict(
                        self._space.config_from_id(cid))
        return best_cfg, best_val, n_ok


class WarmStartManager:
    """Launches at most one journaled recording campaign per cold key.

    ``ensure`` is the single-flight gate: the first caller creates the
    flight (a daemon thread running ``Tuner.record``); every later caller
    of the same (kernel, device, problem) gets the same flight object.
    ``launches`` counts actual campaign starts — the observable the
    single-flight tests assert on. ``runner`` None picks the runner by
    key (``runner_for``); ``device`` is where a live flight runs.
    """

    def __init__(self, hub, runner: str | None = None, max_evals: int = 32,
                 repeats: int = 3, workers: int = 1, seed: int = 0,
                 journal_dir: str | None = None, background: bool = True,
                 device: str | None = None):
        self._hub = hub
        self.runner = runner
        self.device = device
        self._live_label: str | None = None
        self.max_evals = max_evals
        self.repeats = repeats
        self.workers = workers
        self.seed = seed
        self.journal_dir = journal_dir or os.path.join(hub.root, ".warmstart")
        self.background = background
        self.launches = 0
        self._flights: dict[tuple, WarmStartFlight] = {}
        self._lock = threading.Lock()

    def runner_for(self, device: str) -> str:
        """The runner of a flight for a key on ``device``: ``runner`` when
        given, else the cost model for a device model and ``live`` for
        anything else."""
        from ..core.devices import DEVICES_BY_NAME
        if self.runner is not None:
            return self.runner
        return "costmodel" if device in DEVICES_BY_NAME else "live"

    def live_label(self) -> str:
        """The label of the device a live flight runs on (resolved once:
        the card's name, or ``cpu``)."""
        if self._live_label is None:
            self._live_label = device_label(resolve_device(self.device))
        return self._live_label

    def can_serve(self, kernel: str, device: str) -> bool:
        """Warm-start needs a registered kernel (to rebuild its space) and
        a known device model (for the model-backed runners), or, for a
        live flight, the label of the device it runs on."""
        from ..core.devices import DEVICES_BY_NAME
        from ..kernels import KERNELS
        if kernel not in KERNELS:
            return False
        if self.runner_for(device) in ("costmodel", "surrogate"):
            return device in DEVICES_BY_NAME
        return device == self.live_label()

    def ensure(self, kernel: str, device: str,
               problem: Mapping | None) -> WarmStartFlight:
        """Get-or-start the flight for a cold key (the single-flight gate)."""
        problem = dict(problem or {})
        key = (kernel, device, storage.problem_key(problem))
        with self._lock:
            flight = self._flights.get(key)
            if flight is not None:
                return flight
            suffix = ("." + key[2].replace("=", "-").replace(",", "_")
                      if key[2] else "")
            prefix = os.path.join(self.journal_dir,
                                  f"{kernel}@{device}{suffix}")
            flight = WarmStartFlight(kernel, device, problem, prefix,
                                     max(1, self.workers))
            self._flights[key] = flight
            self.launches += 1
        thread = threading.Thread(target=self._run, args=(flight,),
                                  name=f"warmstart-{kernel}@{device}",
                                  daemon=True)
        if self.background:
            thread.start()
        else:
            self._run(flight)
        return flight

    def _run(self, flight: WarmStartFlight) -> None:
        from ..api import Tuner
        try:
            out = flight.prefix + ".json.gz"
            with Tuner(workers=self.workers, seed=self.seed,
                       device=self.device) as tuner:
                run = tuner.record(
                    flight.kernel, runner=self.runner_for(flight.device),
                    device=flight.device,
                    problem=flight.problem, repeats=self.repeats,
                    max_evals=self.max_evals, out=out)
            storage.register_cache(self._hub.root, run.cache,
                                   problem=flight.problem or None)
            from .hub import notify_cache_merged
            notify_cache_merged(self._hub.root, kernel=flight.kernel)
        except BaseException as e:  # surfaced via flight.error, not lost
            flight.error = e
        finally:
            flight.done.set()

    def serve(self, kernel: str, device: str, problem: dict):
        """The hub's cold-path hook: ensure the flight exists and answer
        from it (completed campaign -> the freshly registered exact entry;
        otherwise the journal's incumbent best)."""
        from .hub import LookupResult
        flight = self.ensure(kernel, device, problem)
        if flight.done.is_set() and flight.error is None:
            # probe the freshly registered entry directly (not via
            # hub.lookup, whose cold path would re-enter this method)
            ikey = (kernel, device, storage.problem_key(problem))
            entry = self._hub._index.get(ikey)
            if entry is not None and entry.n_ok > 0:
                config, value, n_ok = self._hub._best_for(ikey)
                if config is not None:
                    return LookupResult(
                        kernel=kernel, device=device, problem=dict(problem),
                        status="warm", best_config=config, best_value=value,
                        confidence=1.0, source=entry.key, n_configs=n_ok)
            return None
        config, value, n_ok = flight.incumbent()
        return LookupResult(
            kernel=kernel, device=device, problem=dict(problem),
            status="warming", best_config=config, best_value=value,
            confidence=n_ok / (n_ok + CONFIDENCE_SCALE),
            source=f"warmstart:{os.path.basename(flight.prefix)}",
            n_configs=n_ok)

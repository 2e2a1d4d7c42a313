"""The FAIR benchmark hub on disk: build, load, verify and register.

A hub is one directory holding T4-mini cache files (``core.cache``) and a
``manifest.json`` that indexes them:

    {"version": 1,
     "files": {"gemm@tpu_v5e": {"path": "gemm@tpu_v5e.json.gz",
                                "sha256": "...", "n_configs": 10140,
                                "n_ok": 10140},
               "gemm@nvidia_h100_80gb_hbm3#k=128,m=128,n=128": {
                   ..., "problem": {"k": 128, "m": 128, "n": 128}}},
     "kernels": {"gemm": {"problem": {"k": 4096, "m": 4096, "n": 4096}}},
     "bruteforce_hours": {"gemm": {"tpu_v5e": 12.3}},
     "build_wall_seconds": 14.2}

An entry's key is ``kernel@device`` for the kernel's default shape
(``hub_default_problem``) and ``kernel@device#<problem_key>`` for any other
shape; an extra shape's entry carries its ``problem``. Every file is
pinned by its sha256: ``read_manifest``, ``load_cache`` and ``load_hub``
raise ``HubError`` on a missing hub, a corrupt manifest or a digest
mismatch instead of rebuilding anything (``verify=False`` skips the
digests). ``write_manifest`` is atomic, and ``register_cache`` folds a new
recording into a hub, creating the hub when there is none.

Port of ``src/repro/hub/storage.py``, which the reference's tree does not
hold (its ``.gitignore`` line ``hub/`` also matched the package); this
module is rebuilt from the contract its callers read: the exports of
``src/repro/hub/__init__.py``, the manifest fields that
``src/repro/service/hub.py``, ``src/repro/api.py`` and ``src/repro/cli.py``
read, the imports of the ``core/dataset.py`` shim, docs/service.md and the
assertions of the reference's hub tests. Changes beyond that contract:

  * ``build_hub`` takes keyword-only ``device`` (where the two framework
    kernels' smoke recordings run live: the card unless ``"cpu"``; their
    label is the card's name, or ``cpu``), and ``kernels`` and ``devices``
    filters that narrow a build (the default is the full hub);
  * the cost-model entries are brute-forced in memory through the same
    ``RecordSpec`` runner as ``python -m repro_torch bruteforce``: the
    ``results`` are the recorder's, bit for bit, without its crash-safe
    shards (an fsync per observation made them ten times slower);
  * ``register_cache`` resolves ``problem`` as overrides of the kernel's
    default shape, as every lookup does, so a partial shape and its full
    form name one entry.
"""
from __future__ import annotations

import hashlib
import inspect
import json
import os
import pathlib
import shutil
import time
from typing import Callable, Mapping, Sequence

from ..core import record as rec
from ..core.budget import Budget
from ..core.cache import CacheFile
from ..core.devices import HUB_DEVICES, TEST_DEVICES, TRAIN_DEVICES

HUB_VERSION = 1
MANIFEST = "manifest.json"
# the repository root's hub/ (listed in .gitignore), normalised: no "..",
# whatever the working directory
DEFAULT_ROOT = str(pathlib.Path(__file__).resolve().parents[3] / "hub")
CACHE_EXT = ".json.gz"
SMOKE_REPEATS = 3       # observations per config of a live smoke recording


class HubError(ValueError):
    """A hub that is missing, corrupt, or fails its sha256 verification."""


# ----------------------------------------------------------------- keys
def problem_key(problem: Mapping | None) -> str:
    """Canonical text of a problem shape: ``k=v`` pairs, sorted, joined by
    commas (``""`` for an empty shape)."""
    return ",".join(f"{k}={v}" for k, v in sorted((problem or {}).items()))


def entry_key(kernel: str, device: str, pkey: str = "") -> str:
    """``kernel@device``, or ``kernel@device#pkey`` for an extra shape."""
    return f"{kernel}@{device}" + (f"#{pkey}" if pkey else "")


def split_key(key: str) -> tuple[str, str, str]:
    """``(kernel, device, pkey)`` of an entry key; ``pkey`` is ``""`` for
    the kernel's default shape."""
    kernel, sep, rest = key.partition("@")
    if not sep or not kernel or not rest:
        raise HubError(f"malformed hub key {key!r}")
    device, _, pkey = rest.partition("#")
    return kernel, device, pkey


def hub_default_problem(kernel: str) -> dict:
    """The shape a bare lookup of ``kernel`` means: for the four hub
    kernels the hub sizes ``build_hub`` brute-forces (``space()``'s
    defaults), for the framework kernels their ``SMOKE_PROBLEM`` (what the
    hub records live), and ``{}`` for a kernel outside the registry."""
    from ..kernels import FRAMEWORK_KERNELS, HUB_KERNELS
    if kernel in HUB_KERNELS:
        params = inspect.signature(HUB_KERNELS[kernel].space).parameters
        return {name: p.default for name, p in params.items()
                if p.default is not inspect.Parameter.empty}
    if kernel in FRAMEWORK_KERNELS:
        return dict(FRAMEWORK_KERNELS[kernel].SMOKE_PROBLEM)
    return {}


def _file_name(kernel: str, device: str, pkey: str) -> str:
    slug = pkey.replace("=", "-").replace(",", "_")
    return f"{kernel}@{device}" + (f".{slug}" if slug else "") + CACHE_EXT


# ------------------------------------------------------------- manifest
def new_manifest() -> dict:
    """The manifest of a hub with no entries."""
    return {"version": HUB_VERSION, "files": {}, "kernels": {},
            "bruteforce_hours": {}, "build_wall_seconds": 0.0}


def _sha256(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            digest.update(block)
    return digest.hexdigest()


def read_manifest(root: str = DEFAULT_ROOT) -> dict:
    """The hub's manifest. Raises ``HubError`` when ``root`` holds none or
    it is not a hub manifest."""
    path = os.path.join(root, MANIFEST)
    try:
        with open(path, "r", encoding="utf-8") as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise HubError(f"no hub manifest at {path}; build one with "
                       f"`python -m repro_torch hub build --root {root}`")
    except (OSError, ValueError) as e:
        raise HubError(f"corrupt hub manifest at {path}: {e}")
    if not isinstance(manifest, dict) or not isinstance(
            manifest.get("files"), dict):
        raise HubError(f"corrupt hub manifest at {path}: no 'files' index")
    if manifest.get("version", HUB_VERSION) > HUB_VERSION:
        raise HubError(f"hub at {root} has version {manifest['version']}; "
                       f"this package reads up to {HUB_VERSION}")
    return manifest


def write_manifest(root: str, manifest: Mapping) -> None:
    """Write the manifest atomically (a temporary file, fsync'd, then
    renamed over the old one)."""
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, MANIFEST)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def verify_manifest(root: str = DEFAULT_ROOT) -> dict:
    """sha256-check every indexed file: ``{key: reason}`` of the entries
    that fail (empty when the hub is intact)."""
    manifest = read_manifest(root)
    failures = {}
    for key, entry in sorted(manifest["files"].items()):
        path = os.path.join(root, entry["path"])
        if not os.path.exists(path):
            failures[key] = f"missing file {entry['path']}"
        elif _sha256(path) != entry.get("sha256"):
            failures[key] = "sha256 mismatch"
    return failures


# ---------------------------------------------------------------- loads
def load_cache(root: str, key: str, manifest: Mapping | None = None,
               verify: bool = True) -> CacheFile:
    """One entry's cache file, its sha256 checked against the manifest
    unless ``verify=False``."""
    manifest = manifest if manifest is not None else read_manifest(root)
    entry = manifest["files"].get(key)
    if entry is None:
        raise HubError(f"no entry {key!r} in the hub at {root}")
    path = os.path.join(root, entry["path"])
    if not os.path.exists(path):
        raise HubError(f"hub entry {key} failed verification: missing "
                       f"file {path}")
    if verify:
        got = _sha256(path)
        if got != entry.get("sha256"):
            raise HubError(
                f"hub entry {key} failed verification: sha256 mismatch "
                f"(manifest {str(entry.get('sha256'))[:12]}, file "
                f"{got[:12]}); rebuild or re-register it, or load with "
                f"verify=False")
    try:
        return CacheFile.load(path)
    except (OSError, ValueError) as e:
        raise HubError(f"hub entry {key} is unreadable: {e}")


def load_hub(root: str = DEFAULT_ROOT, kernels: Sequence[str] | None = None,
             devices: Sequence[str] | None = None,
             verify: bool = True) -> dict:
    """``{(kernel, device): CacheFile}`` of the default-shape entries,
    filtered by ``kernels`` and ``devices`` (extra shapes are skipped)."""
    manifest = read_manifest(root)
    out = {}
    for key in sorted(manifest["files"]):
        kernel, device, pkey = split_key(key)
        if pkey or (kernels is not None and kernel not in kernels) or (
                devices is not None and device not in devices):
            continue
        out[(kernel, device)] = load_cache(root, key, manifest,
                                           verify=verify)
    return out


def train_test_caches(root: str = DEFAULT_ROOT,
                      verify: bool = True) -> tuple:
    """The paper's device split (Sec. IV-A): the default-shape caches of
    ``TRAIN_DEVICES`` and of ``TEST_DEVICES``, each sorted by key."""
    hub = load_hub(root, verify=verify)
    train = [c for (_, d), c in sorted(hub.items()) if d in TRAIN_DEVICES]
    test = [c for (_, d), c in sorted(hub.items()) if d in TEST_DEVICES]
    return train, test


# ----------------------------------------------------------- registering
def _store(root: str, manifest: dict, cache: CacheFile,
           problem: Mapping | None) -> str:
    """Save ``cache`` into the hub layout and index it in ``manifest``
    (not written here); returns the entry key."""
    default = hub_default_problem(cache.kernel)
    resolved = {**default, **dict(problem or {})}
    pkey = problem_key(resolved)
    if pkey == problem_key(default):
        pkey = ""
    key = entry_key(cache.kernel, cache.device, pkey)
    name = _file_name(cache.kernel, cache.device, pkey)
    path = os.path.join(root, name)
    cache.save(path)
    ok = sum(1 for r in cache.results.values() if r.status == "ok")
    entry = {"path": name, "sha256": _sha256(path),
             "n_configs": len(cache.results), "n_ok": ok}
    if pkey:
        entry["problem"] = resolved
    manifest["files"][key] = entry
    if default:
        manifest.setdefault("kernels", {}).setdefault(
            cache.kernel, {"problem": default})
    return key


def register_cache(root: str, cache: CacheFile,
                   problem: Mapping | None = None) -> str:
    """Add a recording to the hub at ``root`` (created when missing) and
    return its entry key. ``problem`` overrides the kernel's default shape;
    ``None`` means the default shape."""
    manifest = _open_manifest(root)
    key = _store(root, manifest, cache, problem)
    write_manifest(root, manifest)
    return key


# ------------------------------------------------------------- building
def t1_descriptor(kernel: str, problem: Mapping | None = None) -> dict:
    """The kernel's search space in the spirit of the BAT T1 input format
    (the FAIR dataset's problem description): name, problem sizes,
    tunables with their values, and the constraints' descriptions."""
    from ..kernels import get_kernel
    resolved = {**hub_default_problem(kernel), **dict(problem or {})}
    space = get_kernel(kernel).space(resolved)
    return {
        "General": {"BenchmarkName": kernel, "FormatVersion": 1},
        "KernelSpecification": {"ProblemSize": resolved},
        "ConfigurationSpace": {
            "TuningParameters": [{"Name": t.name, "Values": list(t.values)}
                                 for t in space.tunables],
            "Conditions": [c.description for c in space.constraints],
        },
    }


def brute_force(kernel: str, device: str,
                problem: Mapping | None = None) -> CacheFile:
    """Cost-model brute force of ``kernel``'s whole valid space on the
    device model ``device`` at ``problem`` (the hub shape when None):
    every valid config through the ``RecordSpec`` cost-model runner, in
    ``valid_configs`` order, with the recorder's metadata."""
    problem = dict(problem if problem is not None
                   else hub_default_problem(kernel))
    spec = rec.RecordSpec.create(kernel, runner="costmodel", device=device,
                                 problem=problem, max_evals=None)
    space, _ = spec.build()
    runner = spec.make_runner(space, Budget())
    results = {space.config_id(c): runner.run(c).result
               for c in space.valid_configs}
    meta = {"recorded": True, "runner": "costmodel", "problem": problem,
            "repeats": spec.repeats, "n_shards": 1,
            "n_configs": len(results),
            "n_ok": sum(1 for r in results.values() if r.status == "ok"),
            "mode": "bruteforce"}
    return CacheFile(kernel, device, space, results, meta)


def _hours(cache: CacheFile) -> float:
    """What recording ``cache`` cost, in simulated (or measured) hours."""
    return sum(r.charge_s for r in cache.results.values()) / 3600.0


def _record_smokes(root: str, manifest: dict, progress: Callable | None,
                   device: str | None,
                   kernels: Sequence[str] | None) -> list[str]:
    """Record the framework kernels live at their smoke shapes into
    ``root``, indexing them in ``manifest`` (not written here)."""
    from ..kernels import FRAMEWORK_KERNELS
    work = os.path.join(root, ".build")
    keys = []
    try:
        for kernel in FRAMEWORK_KERNELS:
            if kernels is not None and kernel not in kernels:
                continue
            spec = rec.RecordSpec.create(kernel, runner="live",
                                         target=device, problem={},
                                         repeats=SMOKE_REPEATS,
                                         max_evals=None)
            out = os.path.join(work, f"{kernel}@{spec.device}{CACHE_EXT}")
            t0 = time.perf_counter()
            cache = rec.record_cache(spec, out, bruteforce=True)
            keys.append(_store(root, manifest, cache, None))
            manifest["bruteforce_hours"].setdefault(kernel, {})[
                spec.device] = _hours(cache)
            if progress is not None:
                progress(f"  {keys[-1]}: {len(cache.results)} configs "
                         f"recorded live on {spec.target} in "
                         f"{time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return keys


def _open_manifest(root: str) -> dict:
    """The manifest of the hub at ``root``, or a new one (the directory
    is created)."""
    os.makedirs(root, exist_ok=True)
    if os.path.exists(os.path.join(root, MANIFEST)):
        return read_manifest(root)
    return new_manifest()


def record_framework_smoke(root: str, progress: Callable | None = print, *,
                           device: str | None = None,
                           kernels: Sequence[str] | None = None) -> list[str]:
    """Record the framework kernels (flash attention, the SSD) live at
    their smoke shapes, over their whole valid spaces, on ``device`` (the
    card unless ``"cpu"``), and register them; their label is the card's
    name, or ``cpu``. Returns the entry keys."""
    manifest = _open_manifest(root)
    keys = _record_smokes(root, manifest, progress, device, kernels)
    write_manifest(root, manifest)
    return keys


def build_hub(root: str = DEFAULT_ROOT, progress: Callable | None = print, *,
              device: str | None = None,
              kernels: Sequence[str] | None = None,
              devices: Sequence[str] | None = None) -> dict:
    """Build the hub at ``root`` and return its manifest.

    The full hub is 26 entries: the four hub kernels brute-forced at their
    hub sizes through the cost model on each of the six device models of
    ``core/devices.py`` (24), plus flash attention and the SSD recorded
    live at their smoke shapes on ``device`` (``record_framework_smoke``).
    That is the count the reference's changelog records for this build;
    its architecture diagram's "6 kernels x 6 device models" predates the
    framework kernels' live entries, and a cost-model brute force of the
    framework kernels was never part of the hub. ``kernels`` and
    ``devices`` narrow the build (``devices`` only filters device
    models); entries already in a hub at ``root`` and not rebuilt stay.
    """
    from ..kernels import HUB_KERNELS
    t0 = time.perf_counter()
    say = progress or (lambda msg: None)
    manifest = _open_manifest(root)
    models = [d.name for d in HUB_DEVICES
              if devices is None or d.name in devices]
    for kernel in HUB_KERNELS:
        if kernels is not None and kernel not in kernels:
            continue
        for model in models:
            t1 = time.perf_counter()
            cache = brute_force(kernel, model)
            key = _store(root, manifest, cache, None)
            manifest["bruteforce_hours"].setdefault(kernel, {})[model] = \
                _hours(cache)
            say(f"  {key}: {len(cache.results)} configs brute-forced "
                f"through the cost model in {time.perf_counter() - t1:.1f} s")
    _record_smokes(root, manifest, progress, device, kernels)
    manifest["build_wall_seconds"] = time.perf_counter() - t0
    write_manifest(root, manifest)
    return manifest

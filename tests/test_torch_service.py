"""The port's ConfigHub service (``repro_torch.service``).

The reference's ``repro.service`` cannot be imported in this tree (its
package reaches the missing ``repro.hub.storage``), so its 24 tests in
``tests/test_service.py`` are ported here and run against the port:
lookup semantics, transfer determinism, single-flight warm start,
invalidation, pickling and the shims, with the same assertions. The
port's own additions follow: a live warm-start flight on the CPU (the
port's kernels' plain versions, on the flight's background thread), and
the live-label rule of ``WarmStartManager.can_serve``. The transfer
functions are held bit for bit against the reference's in
``tests/test_torch_scenarios.py``.
"""
from __future__ import annotations

import os
import pickle
import threading

import pytest

from repro_torch.core.cache import CachedResult, CacheFile
from repro_torch.core.searchspace import SearchSpace
from repro_torch.core.tunable import tunables_from_dict
from repro_torch.hub import storage
from repro_torch.service import (ConfigHub, notify_cache_merged,
                                 shape_distance, transfer_confidence)


def toy_cache(kernel: str, device: str, values, n_err: int = 0) -> CacheFile:
    """A tiny deterministic cache: config x=i scores ``values[i]``."""
    space = SearchSpace(tunables_from_dict(
        {"x": tuple(range(len(values) + n_err))}), name=f"{kernel}@{device}")
    results = {}
    for i, cfg in enumerate(space.valid_configs):
        key = space.config_id(cfg)
        if i < len(values):
            v = float(values[i])
            results[key] = CachedResult("ok", v, (v,), 0.1)
        else:
            results[key] = CachedResult("error", float("inf"), (), 0.1)
    return CacheFile(kernel, device, space, results, {})


@pytest.fixture()
def toy_root(tmp_path):
    """A synthetic hub: one kernel, two devices, three problem shapes."""
    root = str(tmp_path / "hub")
    storage.register_cache(root, toy_cache("toy", "devA", [3.0, 1.0, 2.0]),
                           problem={"m": 64})
    storage.register_cache(root, toy_cache("toy", "devA", [5.0, 4.0]),
                           problem={"m": 128})
    storage.register_cache(root, toy_cache("toy", "devB", [9.0, 8.0]),
                           problem={"m": 64})
    return root


def _join_flights(hub) -> None:
    """Leave no warm-start thread behind a test."""
    for flight in list(hub.warm_start._flights.values()):
        assert flight.join(300.0)


# ------------------------------------------------------------------ lookup
def test_exact_hit(toy_root):
    hub = ConfigHub(toy_root)
    r = hub.lookup("toy", {"m": 64}, "devA")
    assert r.status == "exact" and r.confidence == 1.0
    assert r.best_config == {"x": 1} and r.best_value == 1.0
    assert r.source == "toy@devA#m=64" and r.n_configs == 3
    assert r.found and r.mode == "lookup"


def test_exact_hit_touches_disk_once(toy_root, monkeypatch):
    hub = ConfigHub(toy_root)
    assert hub.disk_loads == 0  # construction reads only the manifest
    hub.lookup("toy", {"m": 64}, "devA")
    assert hub.disk_loads == 1
    # after warm-up the hot path must not be able to touch disk at all
    monkeypatch.setattr(storage, "load_cache",
                        lambda *a, **k: pytest.fail("disk on hot path"))
    for _ in range(32):
        r = hub.lookup("toy", {"m": 64}, "devA")
    assert r.status == "exact" and hub.disk_loads == 1


def test_transfer_same_device_shape_miss(toy_root):
    hub = ConfigHub(toy_root)
    r = hub.lookup("toy", {"m": 96}, "devA")
    assert r.status == "transfer"
    # m=128 is log-nearer to 96 than m=64 is (ln(128/96) < ln(96/64))
    assert r.source == "toy@devA#m=128"
    assert r.best_config == {"x": 1}
    assert r.donor_problem == {"m": 128}
    assert r.distance == pytest.approx(shape_distance({"m": 96}, {"m": 128}))
    assert r.confidence == pytest.approx(
        transfer_confidence(r.distance, cross_device=False))
    assert 0.0 < r.confidence < 1.0


def test_transfer_prefers_same_device_shape_over_cross_device_exact():
    # ordering is by distance first: an exact shape on another device beats
    # a different shape on the requested device
    assert (0.0, True) < (shape_distance({"m": 128}, {"m": 64}), False)


def test_transfer_cross_device(toy_root):
    hub = ConfigHub(toy_root)
    r = hub.lookup("toy", {"m": 64}, "devC")
    assert r.status == "transfer" and r.source == "toy@devA#m=64"
    assert r.confidence == pytest.approx(
        transfer_confidence(0.0, cross_device=True))


def test_transfer_tiebreak_is_deterministic(tmp_path):
    # two donors at identical distance (ln 2 on either side of m=64) and
    # identical device: the lexicographically smaller problem_key wins,
    # independent of registration order
    for order in (("a", "b"), ("b", "a")):
        root = str(tmp_path / f"hub-{order[0]}")
        caches = {"a": ({"m": 32}, [2.0]), "b": ({"m": 128}, [4.0])}
        for name in order:
            problem, values = caches[name]
            storage.register_cache(root, toy_cache("toy", "devA", values),
                                   problem=problem)
        r = ConfigHub(root).lookup("toy", {"m": 64}, "devA")
        assert r.status == "transfer"
        assert r.source == "toy@devA#m=128"  # "m=128" < "m=32" lexicographic


def test_cold_without_warm_start(toy_root):
    hub = ConfigHub(toy_root)
    r = hub.lookup("other_kernel", {"m": 8}, "devA")
    assert r.status == "cold" and r.best_config is None and not r.found
    assert r.confidence == 0.0


def test_lookup_many_batches(toy_root):
    hub = ConfigHub(toy_root)
    rs = hub.lookup_many([
        {"kernel": "toy", "problem": {"m": 64}, "device": "devA"},
        {"kernel": "toy", "problem": {"m": 64}, "device": "devA"},
        {"kernel": "toy", "problem": {"m": 96}, "device": "devA"},
    ])
    assert [r.status for r in rs] == ["exact", "exact", "transfer"]
    # two distinct entries served (m=64 exact, m=128 donor), each loaded once
    assert hub.disk_loads == 2


def test_shape_distance_properties():
    assert shape_distance({"m": 64}, {"m": 64}) == 0.0
    assert shape_distance({"m": 64}, {"m": 128}) == \
        shape_distance({"m": 128}, {"m": 64})
    # unshared dimensions cost a flat penalty on top of the shared part
    d_shared = shape_distance({"m": 64}, {"m": 64, "n": 32})
    assert d_shared == pytest.approx(1.0)
    # non-numeric dims compare by equality
    assert shape_distance({"layout": "nchw"}, {"layout": "nchw"}) == 0.0
    assert shape_distance({"layout": "nchw"}, {"layout": "nhwc"}) == 1.0


# --------------------------------------------------------- warm-start path
def test_single_flight_warm_start(tmp_path):
    root = str(tmp_path / "hub")
    # seed the root with an unrelated kernel so the manifest exists
    storage.register_cache(root, toy_cache("toy", "devA", [1.0]),
                           problem={"m": 64})
    hub = ConfigHub(root, warm_start={"max_evals": 4, "workers": 1})
    from repro_torch.kernels import get_kernel
    problem = get_kernel("ssd").problem()  # smoke sizes: cheap space

    results, barrier = [], threading.Barrier(2)

    def go():
        barrier.wait()
        results.append(hub.lookup("ssd", problem, "tpu_v5e"))

    threads = [threading.Thread(target=go) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert {r.status for r in results} <= {"warming", "warm"}
    assert hub.warm_start.launches == 1  # single-flight: one campaign

    flight = hub.warm_start.ensure("ssd", "tpu_v5e", problem)
    assert flight.join(120.0) and flight.error is None
    r = hub.lookup("ssd", problem, "tpu_v5e")
    assert r.status == "exact" and r.best_config is not None
    assert hub.stats()["warm_campaigns"] == 1
    # the campaign journal is on disk (crash-safe, resumable shards)
    journal_dir = os.path.join(root, ".warmstart")
    assert any(p.endswith(".jsonl") for p in os.listdir(journal_dir))


def test_warm_start_not_used_for_unknown_kernel(toy_root):
    hub = ConfigHub(toy_root, warm_start=True)
    r = hub.lookup("definitely_not_registered", {"m": 4}, "tpu_v5e")
    assert r.status == "cold" and hub.warm_start.launches == 0


# ----------------------------------------------------------- invalidation
def test_register_invalidates_live_service(toy_root):
    hub = ConfigHub(toy_root)
    assert hub.lookup("toy", {"m": 64}, "devA").best_value == 1.0
    # a re-recording found a better config; registering it must evict the
    # live service's precomputed best (the merge-cache --hub-root hook)
    storage.register_cache(toy_root, toy_cache("toy", "devA", [3.0, 0.5]),
                           problem={"m": 64})
    notified = notify_cache_merged(toy_root, kernel="toy")
    assert notified >= 1
    r = hub.lookup("toy", {"m": 64}, "devA")
    assert r.best_value == 0.5 and r.n_configs == 2


def test_ttl_picks_up_changed_file(toy_root):
    hub = ConfigHub(toy_root, ttl_s=0.0)  # every lookup re-stats
    assert hub.lookup("toy", {"m": 64}, "devA").best_value == 1.0
    loads = hub.disk_loads
    # unchanged file: TTL refresh re-stats but must not re-load
    assert hub.lookup("toy", {"m": 64}, "devA").best_value == 1.0
    assert hub.disk_loads == loads
    storage.register_cache(toy_root, toy_cache("toy", "devA", [0.25]),
                           problem={"m": 64})
    assert hub.lookup("toy", {"m": 64}, "devA").best_value == 0.25


# ------------------------------------------------------- pickling / lint
def test_confighub_pickles_without_columns(toy_root):
    hub = ConfigHub(toy_root)
    hub.lookup("toy", {"m": 64}, "devA")
    state = hub.__getstate__()
    assert state["_lock"] is None and state["_materialized"] == {}
    assert state["_warm"] is None
    clone = pickle.loads(pickle.dumps(hub))
    # the computed best ships; the hot path works without any re-loading
    r = clone.lookup("toy", {"m": 64}, "devA")
    assert r.status == "exact" and r.best_value == 1.0
    assert clone.disk_loads == hub.disk_loads


def test_service_package_is_parity_lint_clean():
    from repro_torch.analysis import default_rules, lint_paths
    pkg = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch")
    result = lint_paths([os.path.join(pkg, "service"),
                         os.path.join(pkg, "hub")], rules=default_rules())
    assert result.ok, [f"{f.rule}:{f.path}:{f.line}"
                       for f in result.findings]


# ------------------------------------------------ hub storage / facade
def test_missing_hub_errors_instead_of_rebuilding(tmp_path):
    from repro_torch.hub import HubError
    with pytest.raises(HubError, match="no hub manifest"):
        storage.load_hub(str(tmp_path / "nope"))


def test_sha256_verification_and_escape_hatch(toy_root):
    from repro_torch.hub import HubError
    manifest = storage.read_manifest(toy_root)
    key = "toy@devA#m=64"
    # stale manifest: the recorded digest no longer matches the file
    manifest["files"][key]["sha256"] = "0" * 64
    storage.write_manifest(toy_root, manifest)
    with pytest.raises(HubError, match="sha256 mismatch"):
        storage.load_cache(toy_root, key)
    with pytest.raises(HubError, match="failed verification"):
        ConfigHub(toy_root).lookup("toy", {"m": 64}, "devA")
    assert key in storage.verify_manifest(toy_root)
    # the explicit escape hatch still reads the intact file as-is
    cache = storage.load_cache(toy_root, key, verify=False)
    assert cache.kernel == "toy"
    r = ConfigHub(toy_root, verify=False).lookup("toy", {"m": 64}, "devA")
    assert r.status == "exact" and r.best_value == 1.0


def test_hub_facade_verify_and_stats(toy_root):
    from repro_torch.api import Hub
    hub = Hub(toy_root)
    assert hub.verify() == {}
    st = hub.stats(device="cpu")
    assert st["entries"] == 3 and st["kernels"] == ["toy"]
    assert st["devices"] == ["devA", "devB"]
    r = hub.lookup("toy", {"m": 64}, "devA")
    assert r.status == "exact"
    assert hub.stats(device="cpu")["service"]["lookups"]["exact"] == 1


def test_default_root_is_normalized():
    from repro_torch.hub import DEFAULT_ROOT
    assert ".." not in DEFAULT_ROOT
    assert DEFAULT_ROOT == os.path.normpath(DEFAULT_ROOT)


# ---------------------------------------------------- deprecation shims
def test_dataset_shims_warn_and_delegate(toy_root):
    from repro_torch.core import dataset
    from repro_torch.deprecations import HubDeprecationWarning
    with pytest.warns(HubDeprecationWarning,
                      match="repro_torch.hub.load_hub"):
        old = dataset.load_hub(toy_root)
    new = storage.load_hub(toy_root)
    assert set(old) == set(new)  # suffixed entries are skipped identically
    for k in old:
        assert old[k].results == new[k].results


def test_train_test_caches_shim_warns(toy_root):
    from repro_torch.core import dataset
    from repro_torch.deprecations import HubDeprecationWarning
    with pytest.warns(HubDeprecationWarning):
        train, test = dataset.train_test_caches(toy_root)
    assert train == [] and test == []  # toy devices are in neither split


def test_serving_import_shim_warns():
    import importlib
    import sys
    from repro_torch.deprecations import ServingMovedWarning
    sys.modules.pop("repro_torch.serving", None)
    sys.modules.pop("repro_torch.serving.engine", None)
    with pytest.warns(ServingMovedWarning, match="repro_torch.inference"):
        import repro_torch.serving  # noqa: F401
        importlib.import_module("repro_torch.serving.engine")
    from repro_torch.inference.engine import ServingEngine
    assert sys.modules["repro_torch.serving.engine"].ServingEngine \
        is ServingEngine


# ----------------------------------------------------------- CLI surface
def test_cli_lookup_and_serve(toy_root, capsys):
    import json

    from repro_torch.cli import main, serve_requests
    assert main(["lookup", "--hub-root", toy_root, "--kernel", "toy",
                 "--problem", "m=64", "--device", "devA", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["status"] == "exact" and out["best_config"] == {"x": 1}

    hub = ConfigHub(toy_root)
    lines = [
        json.dumps({"kernel": "toy", "problem": {"m": 64},
                    "device": "devA"}),
        json.dumps([{"kernel": "toy", "device": "devA"},
                    {"kernel": "toy", "problem": {"m": 96},
                     "device": "devA"}]),
        "not json",
        "",
    ]
    results = list(serve_requests(hub, lines))
    assert [r.get("status") for r in results[:3]] == \
        ["exact", "transfer", "transfer"]
    assert "error" in results[3]


def test_cli_merge_cache_registers_into_hub(toy_root, tmp_path, capsys):
    from repro_torch.cli import main
    # produce one tiny costmodel recording shard via the facade
    from repro_torch.api import Tuner
    out = str(tmp_path / "rec" / "ssd.json.gz")
    with Tuner(workers=1) as tuner:
        run = tuner.record("ssd", runner="costmodel", device="tpu_v5e",
                           max_evals=4, out=out)
    shard = out[:-len(".json.gz")] + ".shard-00.jsonl"
    live = ConfigHub(toy_root)
    # nothing recorded for ssd in the toy hub: the roofline surrogate
    # answers (modeled tier) until the recording below is registered
    assert live.lookup("ssd", None, "tpu_v5e").status == "modeled"
    merged = str(tmp_path / "rec" / "merged.json.gz")
    assert main(["merge-cache", shard, "--out", merged,
                 "--hub-root", toy_root]) == 0
    assert "registered in hub" in capsys.readouterr().out
    # the live service was invalidated and now serves the recording
    r = live.lookup("ssd", run.cache.meta["problem"], "tpu_v5e")
    assert r.status == "exact" and r.best_value == run.best_value


# --------------------------------------------------- the port's additions
def test_live_warm_start_records_the_live_device(tmp_path):
    """A cold key on the live device's label ("cpu" here) warms through a
    live recording on a background thread; the incumbent is served while
    it runs, then the registered entry answers exactly."""
    from repro_torch.kernels import dedispersion
    root = str(tmp_path / "hub")
    storage.write_manifest(root, storage.new_manifest())  # an empty hub
    hub = ConfigHub(root, warm_start={"max_evals": 4, "device": "cpu"})
    problem = dict(dedispersion.SMOKE_PROBLEM)
    r = hub.lookup("dedispersion", problem, "cpu")
    assert r.status in ("warming", "warm") and r.tier == "warm"
    assert r.source.startswith("warmstart:") or r.status == "warm"
    assert 0.0 <= r.confidence < 1.0 or r.status == "warm"
    _join_flights(hub)
    flight = hub.warm_start.ensure("dedispersion", "cpu", r.problem)
    assert flight.error is None
    r = hub.lookup("dedispersion", problem, "cpu")
    assert r.status == "exact" and r.found
    assert r.source == "dedispersion@cpu#" + storage.problem_key(r.problem)
    assert hub.warm_start.launches == 1
    cache = storage.load_cache(root, r.source)
    assert cache.meta["runner"] == "live" and len(cache.results) == 4


def test_live_warm_start_only_for_the_live_label(tmp_path):
    root = str(tmp_path / "hub")
    storage.write_manifest(root, storage.new_manifest())
    hub = ConfigHub(root, warm_start={"max_evals": 4, "device": "cpu"})
    manager = hub.warm_start
    assert manager.runner_for("tpu_v5e") == "costmodel"
    assert manager.runner_for("cpu") == "live"
    assert manager.can_serve("gemm", "cpu")
    # another card's label cannot be recorded from here, and is not a
    # device model: nothing to warm, nothing to model
    assert not manager.can_serve("gemm", "nvidia_h100_80gb_hbm3")
    r = hub.lookup("gemm", None, "nvidia_h100_80gb_hbm3")
    assert r.status == "cold" and manager.launches == 0


def test_warm_up_recorded_keys_and_stats(toy_root):
    hub = ConfigHub(toy_root)
    assert hub.warm_up(devices=("devA",)) == 2
    assert hub.disk_loads == 2
    assert hub.recorded_keys() == frozenset({
        ("toy", "devA", "m=64"), ("toy", "devA", "m=128"),
        ("toy", "devB", "m=64")})
    st = hub.stats()
    assert (st["entries"], st["materialized"]) == (3, 2)
    assert st["lookups"] == {"exact": 0, "transfer": 0, "warm": 0,
                             "modeled": 0, "cold": 0}
    hub.invalidate(device="devA")
    assert hub.stats()["materialized"] == 0


def test_lookup_result_json_and_tier(toy_root):
    hub = ConfigHub(toy_root)
    j = hub.lookup("toy", {"m": 96}, "devA").to_json()
    assert j["tier"] == "transfer" and j["donor_problem"] == {"m": 128}
    assert hub.lookup("nope").to_json()["tier"] == "cold"

"""The port's FAIR hub storage (``repro_torch.hub.storage``).

The reference's ``src/repro/hub/storage.py`` is not in its tree, so the
storage is held against its contract: the manifest fields that the
reference's callers read, docs/service.md, and the assertions of the
reference's hub tests (``tests/test_system.py``'s three hub tests run here
on the same slice: gemm and hotspot on tpu_v5e and tpu_lite_b). What can
be run is run: a cost-model entry's ``results`` equal, bit for bit, what
the reference's own ``repro.core.record`` cost-model brute force writes
for the same kernel, device model and problem (no tolerance).

Everything runs on ``device="cpu"``: the framework kernels' smoke
recordings run their plain PyTorch versions.
"""
import json
import os
import subprocess
from pathlib import Path

import pytest

from repro_torch.core.cache import result_to_json
from repro_torch.hub import storage

REPO = Path(__file__).resolve().parents[1]
SLICE_KERNELS = ("gemm", "hotspot")
SLICE_DEVICES = ("tpu_v5e", "tpu_lite_b")


@pytest.fixture(scope="module")
def slice_root(tmp_path_factory):
    """The hub slice of the reference's system tests, built by the port."""
    root = str(tmp_path_factory.mktemp("hub"))
    storage.build_hub(root, progress=None, device="cpu",
                      kernels=SLICE_KERNELS, devices=SLICE_DEVICES)
    return root


@pytest.fixture(scope="module")
def hub_slice(slice_root):
    return storage.load_hub(slice_root, kernels=SLICE_KERNELS,
                            devices=SLICE_DEVICES)


@pytest.fixture(scope="module")
def smoke_root(tmp_path_factory):
    """Flash attention's and the SSD's smoke recordings, live on the CPU."""
    root = str(tmp_path_factory.mktemp("smoke"))
    storage.build_hub(root, progress=None, device="cpu",
                      kernels=("flash_attention", "ssd"))
    return root


# ------------------------------------------------------ the system tests
def test_hub_is_valid(hub_slice):
    assert len(hub_slice) == 4
    for (k, d), cache in hub_slice.items():
        assert cache.meta["n_ok"] > 0.8 * cache.meta["n_configs"]


def test_tuning_the_tuner_end_to_end(hub_slice):
    from repro_torch.core.hypertuner import (exhaustive_hypertune,
                                             score_hyperconfig)
    from repro_torch.core.methodology import make_scorer
    scorers = [make_scorer(c, engine="torch", device="cpu")
               for c in hub_slice.values()]
    res = exhaustive_hypertune("greedy_ils", scorers, repeats=4, seed=0)
    best, worst = res.best, res.worst
    assert best.score > worst.score
    re_best = score_hyperconfig("greedy_ils", best.hyperparams, scorers,
                                repeats=4, seed=99)
    re_worst = score_hyperconfig("greedy_ils", worst.hyperparams, scorers,
                                 repeats=4, seed=99)
    assert re_best.score > re_worst.score


def test_simulation_mode_speedup(hub_slice):
    """Simulated tuning must be orders of magnitude faster than the live
    tuning it replays (paper Sec. IV-E)."""
    from repro_torch.core.methodology import evaluate_strategy, make_scorer
    from repro_torch.core.strategies import get_strategy
    scorers = [make_scorer(c, engine="torch", device="cpu")
               for c in list(hub_slice.values())[:2]]
    rep = evaluate_strategy(lambda: get_strategy("random_search"), scorers,
                            repeats=3, seed=0)
    assert rep.simulated_seconds > 50 * rep.wall_seconds


# ----------------------------------------------------------- build_hub
def test_build_hub_slice_manifest(slice_root):
    m = storage.read_manifest(slice_root)
    assert m["version"] == storage.HUB_VERSION
    assert sorted(m["files"]) == sorted(
        f"{k}@{d}" for k in SLICE_KERNELS for d in SLICE_DEVICES)
    assert m["kernels"]["gemm"]["problem"] == {"m": 4096, "n": 4096,
                                               "k": 4096}
    for key, entry in m["files"].items():
        path = os.path.join(slice_root, entry["path"])
        assert entry["sha256"] == storage._sha256(path)
        assert "problem" not in entry  # default shapes only
        kernel, device, _ = storage.split_key(key)
        assert m["bruteforce_hours"][kernel][device] > 0
    assert m["files"]["gemm@tpu_v5e"]["n_configs"] == 10140
    assert m["files"]["hotspot@tpu_v5e"]["n_configs"] == 5040
    assert m["build_wall_seconds"] > 0
    assert storage.verify_manifest(slice_root) == {}


def test_build_hub_framework_smokes_on_cpu(smoke_root):
    from repro_torch.kernels import KERNELS
    m = storage.read_manifest(smoke_root)
    assert sorted(m["files"]) == ["flash_attention@cpu", "ssd@cpu"]
    for kernel in ("flash_attention", "ssd"):
        cache = storage.load_cache(smoke_root, f"{kernel}@cpu")
        space = KERNELS[kernel].space(None)
        assert cache.meta["runner"] == "live"
        assert cache.meta["problem"] == {}
        assert len(cache.results) == space.size  # the whole smoke space
        ok = [r for r in cache.results.values() if r.status == "ok"]
        assert ok and all(len(r.times_s) == storage.SMOKE_REPEATS
                          for r in ok)
        assert m["kernels"][kernel]["problem"] == \
            KERNELS[kernel].module.SMOKE_PROBLEM
    # the build left no recording shards behind
    assert not os.path.exists(os.path.join(smoke_root, ".build"))


def test_build_hub_adds_to_an_existing_hub(tmp_path):
    root = str(tmp_path / "hub")
    storage.register_cache(root, _toy_cache(), problem={"m": 4})
    storage.build_hub(root, progress=None, kernels=("hotspot",),
                      devices=("tpu_lite_b",))
    assert sorted(storage.read_manifest(root)["files"]) == [
        "hotspot@tpu_lite_b", "toy@devA#m=4"]


@pytest.mark.parametrize("kernel,device", [
    ("hotspot", "tpu_v5e"), ("hotspot", "tpu_lite_b"),
    ("dedispersion", "tpu_v5e"), ("dedispersion", "tpu_lite_b")])
def test_cost_model_entry_bit_identical_to_reference(kernel, device,
                                                     slice_root, tmp_path,
                                                     monkeypatch):
    """The reference's ``record`` brute force at the hub size (its own
    shard -> merge path; fsync is a no-op here, which changes nothing that
    is written) against the port's entry: the hub's file for hotspot,
    ``storage.brute_force`` for dedispersion. No tolerance."""
    from repro.core import record as ref_rec
    from repro.core.cache import result_to_json as ref_to_json
    problem = storage.hub_default_problem(kernel)
    monkeypatch.setattr(os, "fsync", lambda fd: None)
    spec = ref_rec.RecordSpec.create(kernel, runner="costmodel",
                                     device=device, problem=problem,
                                     max_evals=None)
    prefix = str(tmp_path / "ref")
    ref_rec.bruteforce_shard_task(spec, 0, 1, prefix)
    ref = ref_rec.merge_shards([ref_rec.shard_path(prefix, 0)])
    if kernel in SLICE_KERNELS:
        ours = storage.load_cache(slice_root, f"{kernel}@{device}")
    else:
        ours = storage.brute_force(kernel, device)
    assert list(ours.results) == list(ref.results)
    assert {k: result_to_json(r) for k, r in ours.results.items()} == \
        {k: ref_to_json(r) for k, r in ref.results.items()}
    assert ours.meta["n_ok"] == ref.meta["n_ok"]


# ------------------------------------------------------- keys and shapes
def test_keys_round_trip():
    assert storage.problem_key({"n": 2, "m": 64}) == "m=64,n=2"
    assert storage.problem_key({}) == storage.problem_key(None) == ""
    assert storage.entry_key("gemm", "tpu_v5e") == "gemm@tpu_v5e"
    key = storage.entry_key("gemm", "tpu_v5e", "m=64")
    assert key == "gemm@tpu_v5e#m=64"
    assert storage.split_key(key) == ("gemm", "tpu_v5e", "m=64")
    assert storage.split_key("ssd@cpu") == ("ssd", "cpu", "")
    with pytest.raises(storage.HubError):
        storage.split_key("no-at-sign")


def test_hub_default_problem():
    from repro_torch.kernels import KERNELS
    assert storage.hub_default_problem("gemm") == {"m": 4096, "n": 4096,
                                                   "k": 4096}
    assert storage.hub_default_problem("hotspot") == {"h": 4096, "w": 4096}
    for kernel in ("gemm", "convolution", "hotspot", "dedispersion"):
        # the shape build_hub brute-forces: the space at its defaults
        space = KERNELS[kernel].space(storage.hub_default_problem(kernel))
        assert space.size == KERNELS[kernel].module.space().size
    for kernel in ("flash_attention", "ssd"):
        assert storage.hub_default_problem(kernel) == \
            KERNELS[kernel].module.SMOKE_PROBLEM
    assert storage.hub_default_problem("toy") == {}


def test_default_root_is_normalized():
    assert ".." not in storage.DEFAULT_ROOT
    assert storage.DEFAULT_ROOT == os.path.normpath(storage.DEFAULT_ROOT)
    assert storage.DEFAULT_ROOT == str(REPO / "hub")


def test_hub_package_is_tracked_by_git():
    """``hub/`` in .gitignore also matches the package: the negation line
    after it keeps ``src/repro_torch/hub/`` in the repository."""
    for path in ("src/repro_torch/hub/__init__.py",
                 "src/repro_torch/hub/storage.py"):
        proc = subprocess.run(["git", "check-ignore", "-q", path], cwd=REPO)
        assert proc.returncode == 1, f"{path} is ignored by git"
    proc = subprocess.run(["git", "check-ignore", "-q", "hub/manifest.json"],
                          cwd=REPO)
    assert proc.returncode == 0  # the hub's data stays ignored


# ------------------------------------------------- manifest and errors
def _toy_cache(kernel="toy", device="devA", values=(3.0, 1.0)):
    from repro_torch.core.cache import CachedResult, CacheFile
    from repro_torch.core.searchspace import SearchSpace
    from repro_torch.core.tunable import tunables_from_dict
    space = SearchSpace(tunables_from_dict({"x": tuple(range(len(values)))}),
                        name=f"{kernel}@{device}")
    results = {space.config_id(c): CachedResult("ok", v, (v,), 0.1)
               for c, v in zip(space.valid_configs, values)}
    return CacheFile(kernel, device, space, results, {})


def test_missing_and_corrupt_hub_raise(tmp_path):
    with pytest.raises(storage.HubError, match="no hub manifest"):
        storage.load_hub(str(tmp_path / "nope"))
    root = tmp_path / "bad"
    root.mkdir()
    (root / storage.MANIFEST).write_text("{not json")
    with pytest.raises(storage.HubError, match="corrupt"):
        storage.read_manifest(str(root))
    (root / storage.MANIFEST).write_text(json.dumps({"version": 1}))
    with pytest.raises(storage.HubError, match="corrupt"):
        storage.read_manifest(str(root))
    assert issubclass(storage.HubError, ValueError)


def test_register_creates_the_hub_and_indexes_shapes(tmp_path):
    root = str(tmp_path / "hub")
    key = storage.register_cache(root, _toy_cache(), problem={"m": 64})
    assert key == "toy@devA#m=64"
    entry = storage.read_manifest(root)["files"][key]
    assert entry["problem"] == {"m": 64}
    assert (entry["n_configs"], entry["n_ok"]) == (2, 2)
    assert storage.register_cache(root, _toy_cache(device="devB")) == \
        "toy@devB"
    # a default shape passed in full, or in part, is the unsuffixed entry
    gemm = _toy_cache(kernel="gemm", device="devA")
    assert storage.register_cache(root, gemm, problem={"m": 4096}) == \
        "gemm@devA"
    assert storage.register_cache(root, gemm, problem={"m": 2048}) == \
        "gemm@devA#k=4096,m=2048,n=4096"
    hub = storage.load_hub(root)
    assert sorted(hub) == [("gemm", "devA"), ("toy", "devB")]
    assert hub[("toy", "devB")].results == _toy_cache().results


def test_sha256_mismatch_and_escape_hatch(tmp_path):
    root = str(tmp_path / "hub")
    key = storage.register_cache(root, _toy_cache())
    manifest = storage.read_manifest(root)
    manifest["files"][key]["sha256"] = "0" * 64
    storage.write_manifest(root, manifest)
    with pytest.raises(storage.HubError, match="sha256 mismatch"):
        storage.load_cache(root, key)
    assert storage.verify_manifest(root) == {key: "sha256 mismatch"}
    assert storage.load_cache(root, key, verify=False).kernel == "toy"
    os.remove(os.path.join(root, manifest["files"][key]["path"]))
    assert "missing file" in storage.verify_manifest(root)[key]
    with pytest.raises(storage.HubError, match="missing file"):
        storage.load_cache(root, key, verify=False)


def test_write_manifest_is_atomic(tmp_path, monkeypatch):
    root = str(tmp_path / "hub")
    storage.register_cache(root, _toy_cache())
    before = storage.read_manifest(root)

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(os, "replace", boom)
    with pytest.raises(OSError):
        storage.write_manifest(root, storage.new_manifest())
    assert storage.read_manifest(root) == before  # the old one is intact


def test_train_test_split(tmp_path):
    root = str(tmp_path / "hub")
    for device in ("tpu_v5e", "tpu_v6e", "devX"):
        storage.register_cache(root, _toy_cache("toy", device))
    train, test = storage.train_test_caches(root)
    assert [c.device for c in train] == ["tpu_v5e"]
    assert [c.device for c in test] == ["tpu_v6e"]


def test_t1_descriptor():
    from repro_torch.kernels import KERNELS
    d = storage.t1_descriptor("hotspot")
    assert d["General"]["BenchmarkName"] == "hotspot"
    assert d["KernelSpecification"]["ProblemSize"] == {"h": 4096, "w": 4096}
    space = KERNELS["hotspot"].space(storage.hub_default_problem("hotspot"))
    assert [p["Name"] for p in
            d["ConfigurationSpace"]["TuningParameters"]] == \
        [t.name for t in space.tunables]


# -------------------------------------------------- the deprecated shim
def test_dataset_shims_warn_and_delegate(tmp_path):
    from repro_torch.core import dataset
    from repro_torch.deprecations import HubDeprecationWarning
    root = str(tmp_path / "hub")
    storage.register_cache(root, _toy_cache(), problem={"m": 4})
    storage.register_cache(root, _toy_cache(device="tpu_v4"))
    with pytest.warns(HubDeprecationWarning, match="repro_torch.hub.load_hub"):
        old = dataset.load_hub(root)
    new = storage.load_hub(root)
    assert set(old) == set(new) == {("toy", "tpu_v4")}
    for k in old:
        assert old[k].results == new[k].results
    with pytest.warns(HubDeprecationWarning):
        train, test = dataset.train_test_caches(root)
    assert [c.device for c in train] == ["tpu_v4"] and test == []
    assert dataset.HubError is storage.HubError
    assert dataset.brute_force is storage.brute_force

"""The port's slice end to end against the reference: record -> merge ->
replay -> score, on the CPU at small sizes.

Scores are compared for exact equality (the torch engine's commits are
bit-identical to the numpy engine's, and scoring is the same numpy code);
caches and shards are compared field for field. The card-side run of the
same path is chip_smoke.py.
"""
import ast
import json
import os
import pathlib
import pickle
import random
import subprocess
import sys

import numpy as np
import pytest
import torch
from _synth import parity_cache

import repro.core.methodology as ref_meth
import repro.core.record as ref_record
from repro.core.cache import CacheFile as RefCacheFile
from repro.core.cache import result_to_json as ref_result_to_json
from repro.core.strategies import get_strategy as ref_get_strategy
from repro_torch.core import methodology, record
from repro_torch.core.budget import Budget
from repro_torch.core.cache import CacheFile, result_to_json
from repro_torch.core.driver import SearchDriver, drive_many
from repro_torch.core.parallel import (CampaignExecutor, StrategyFactory,
                                       _holds_torch_scorer)
from repro_torch.core.runner import SimulationRunner
from repro_torch.core.strategies import get_strategy
from repro_torch.kernels import get_kernel
from repro_torch.kernels import gemm as gm

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


@pytest.fixture(scope="module")
def cache_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("slice") / "parity.json.gz")
    parity_cache().save(path)
    return path


def _ref_report(path, name, repeats):
    return ref_meth.evaluate_strategy(
        lambda: ref_get_strategy(name),
        [ref_meth.make_scorer(RefCacheFile.load(path))], repeats=repeats,
        seed=4)


@pytest.mark.parametrize("engine", ["torch", "vectorized", "scalar"])
@pytest.mark.parametrize("name", ["random_search", "genetic_algorithm"])
def test_scores_equal_reference_exactly(cache_path, name, engine):
    ref = _ref_report(cache_path, name, repeats=6)
    ours = methodology.evaluate_strategy(
        lambda: get_strategy(name),
        [methodology.make_scorer(CacheFile.load(cache_path), engine=engine,
                                 device="cpu")], repeats=6, seed=4)
    assert ours.score == ref.score
    assert np.array_equal(ours.curve, ref.curve)
    assert ours.per_space_score == ref.per_space_score
    assert (ours.fresh_evals, ours.simulated_seconds) == \
        (ref.fresh_evals, ref.simulated_seconds)
    assert ours.fuse == ("sequential" if engine == "scalar" else "host")


def test_torch_engine_dispatches_every_fresh_batch(cache_path):
    cache = CacheFile.load(cache_path)
    scorer = methodology.make_scorer(cache, engine="torch", device="cpu")
    runner = SimulationRunner(cache, Budget(max_seconds=scorer.budget_s),
                              engine="torch", device="cpu")
    get_strategy("genetic_algorithm").run(cache.space, runner,
                                          random.Random(1))
    assert runner.torch_engine().dispatches > 1
    assert runner.fresh_evals > 0


def test_drive_many_engine_switch_and_device_fuse(cache_path):
    cache = CacheFile.load(cache_path)

    def drivers(engine):
        return [SearchDriver(get_strategy("genetic_algorithm"), cache.space,
                             SimulationRunner(cache, Budget(max_evals=70),
                                              engine=engine, device="cpu"),
                             random.Random(100 + i)) for i in range(4)]

    a, b = drivers("numpy"), drivers("numpy")
    drive_many(a)
    for d in b:
        d.runner.device = "cpu"
    drive_many(b, engine="torch")
    assert [d.runner.trace for d in a] == [d.runner.trace for d in b]
    assert all(d.runner.engine == "torch" for d in b)
    with pytest.raises(NotImplementedError, match="later slice"):
        drive_many(drivers("numpy"), fuse="device")
    with pytest.raises(NotImplementedError, match="later slice"):
        methodology.evaluate_strategy(
            lambda: get_strategy("random_search"),
            [methodology.make_scorer(cache, device="cpu")], repeats=1,
            drive="device")


def test_registries_hold_this_slice_only():
    with pytest.raises(KeyError):
        get_strategy("pso")
    with pytest.raises(KeyError):
        get_kernel("convolution")
    assert get_kernel("gemm").module is gm


def test_t4_files_cross_packages_byte_for_byte(tmp_path):
    """A file written by one package loads in the other, and both write
    the same bytes back (a loaded cache's membership space adds its
    constraint description in either package)."""
    ref = parity_cache()
    a, b, c, d = (str(tmp_path / f"{x}.json") for x in "abcd")
    ref.save(a)
    ours = CacheFile.load(a)
    ours.save(b)
    RefCacheFile.load(a).save(c)
    assert pathlib.Path(b).read_bytes() == pathlib.Path(c).read_bytes()
    RefCacheFile.load(b).save(d)
    assert pathlib.Path(d).read_bytes() == pathlib.Path(b).read_bytes()
    assert {k: result_to_json(r) for k, r in ours.results.items()} == \
        ref.to_json()["results"]


def test_cpu_record_merge_round_trip_through_both_packages(tmp_path):
    """A live recording at SMOKE_PROBLEM on the CPU (the GEMM's plain
    version); its shard merges to the same cache through
    ``repro.core.record.merge_shards``."""
    out = str(tmp_path / "gemm.json.gz")
    spec = record.RecordSpec.create("gemm", target="cpu", max_evals=24,
                                    repeats=2, seed=3)
    assert (spec.device, spec.target) == ("cpu", "cpu")
    cache = record.record_cache(spec, out)
    assert cache.kernel == "gemm" and cache.device == "cpu"
    assert len(cache.results) == 24
    assert cache.space.size == 10140  # the registry space, not membership
    statuses = {r.status for r in cache.results.values()}
    assert "ok" in statuses
    for key, r in cache.results.items():
        conf = cache.space.as_dict(cache.space.config_from_id(key))
        assert (r.status == "ok") == gm.fits(conf, torch.bfloat16)
        assert len(r.times_s) == (2 if r.status == "ok" else 0)
    shard = record.shard_path(out[:-len(".json.gz")], 0)
    ref_cache = ref_record.merge_shards([shard])
    assert {k: ref_result_to_json(r) for k, r in ref_cache.results.items()} \
        == {k: result_to_json(r) for k, r in cache.results.items()}
    assert (ref_cache.kernel, ref_cache.device) == ("gemm", "cpu")
    loaded = RefCacheFile.load(out)
    assert list(loaded.results) == list(cache.results)
    # replaying the recording reproduces the recorded trace bit for bit
    ref_scorer = ref_meth.make_scorer(loaded)
    ours_scorer = methodology.make_scorer(CacheFile.load(out), engine="torch",
                                          device="cpu")
    assert (ours_scorer.budget_s, ours_scorer.optimum) == \
        (ref_scorer.budget_s, ref_scorer.optimum)


def test_live_record_on_card_refuses_workers(tmp_path):
    spec = record.RecordSpec(kernel="gemm", device="nvidia_h100",
                             target="cuda")
    with pytest.raises(ValueError, match="one worker"):
        record.record_cache(spec, str(tmp_path / "x.json"), workers=2)


def test_entry_points_without_cuda_raise_unless_cpu(cache_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cache = CacheFile.load(cache_path)
    # the torch engine is the default: no engine named means the card
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SimulationRunner(cache, Budget(max_seconds=1.0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SimulationRunner(cache, Budget(max_seconds=1.0), engine="torch")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        methodology.make_scorer(cache)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        methodology.make_scorer(cache, engine="torch")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gm.make_live()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        record.RecordSpec.create("gemm")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        drive_many([SearchDriver(get_strategy("random_search"), cache.space,
                                 SimulationRunner(cache, Budget(max_evals=3),
                                                  engine="numpy"),
                                 random.Random(0))],
                   engine="torch")


def test_process_pool_spawns_for_torch_scorers(cache_path):
    cache = CacheFile.load(cache_path)
    torch_scorer = methodology.make_scorer(cache, engine="torch",
                                           device="cpu")
    numpy_scorer = methodology.make_scorer(cache, engine="vectorized")
    assert _holds_torch_scorer(((torch_scorer,), None, 0))
    assert not _holds_torch_scorer(((numpy_scorer,), None, 0))
    assert pickle.loads(pickle.dumps(torch_scorer)).device == "cpu"
    factory = StrategyFactory.create("genetic_algorithm", {"popsize": 10})
    serial = methodology.evaluate_strategy(factory, [torch_scorer],
                                           repeats=4, seed=2)
    with CampaignExecutor(workers=2, backend="process") as ex:
        par = methodology.evaluate_strategy(factory, [torch_scorer],
                                            repeats=4, seed=2, executor=ex)
        assert ex._proc_pool._mp_context.get_start_method() == "spawn"
    assert par.score == serial.score
    assert np.array_equal(par.curve, serial.curve)


def _env():
    return {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu"}


def test_cli_record_merge_simulate(tmp_path):
    out = str(tmp_path / "rec.json")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch", "record", "--kernel", "gemm",
         "--device", "cpu", "--max-evals", "12", "--repeats", "1",
         "--out", out], capture_output=True, text=True, env=_env(),
        timeout=300)
    assert r.returncode == 0, r.stderr
    assert "12/10140 configs recorded" in r.stdout
    merged = str(tmp_path / "merged.json")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch", "merge-cache",
         str(tmp_path / "rec.shard-00.jsonl"), "--out", merged],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert r.returncode == 0, r.stderr
    assert json.loads(pathlib.Path(merged).read_text())["results"] == \
        json.loads(pathlib.Path(out).read_text())["results"]
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch", "simulate", "--strategy",
         "random_search", "--cache", merged, "--repeats", "3",
         "--device", "cpu"], capture_output=True, text=True, env=_env(),
        timeout=300)
    assert r.returncode == 0, r.stderr
    assert "aggregate score (Eq. 3)" in r.stdout
    assert "engine torch on cpu" in r.stdout


def _imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted((SRC / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        bad = _imports(path) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{path} imports {bad}"
    modules = sorted(
        ".".join(p.relative_to(SRC).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in (SRC / "repro_torch").rglob("*.py")
        if p.name != "__main__.py")
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=_env(), timeout=300)
    assert r.returncode == 0, r.stderr


def test_default_engine_is_the_torch_engine(cache_path):
    """Naming only the device keeps the torch engine; the host engines are
    opt-ins, and the runner's columnar path follows its engine."""
    cache = CacheFile.load(cache_path)
    scorer = methodology.make_scorer(cache, device="cpu")
    assert (scorer.engine, scorer.device) == ("torch", "cpu")
    runner = SimulationRunner(cache, Budget(max_evals=4), device="cpu")
    assert (runner.engine, runner.device, runner.columnar) == \
        ("torch", "cpu", True)
    assert not SimulationRunner(cache, Budget(max_evals=4),
                                engine="scalar").columnar
    assert methodology.make_scorer(cache, engine="vectorized").device is None

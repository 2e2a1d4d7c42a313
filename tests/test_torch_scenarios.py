"""The port's scenario layer (``repro_torch.scenarios``), its transfer
functions and its roofline copy, against the reference.

Run against the reference, bit for bit (no tolerance):

  * ``roofline.analysis`` directly: ``roofline``, ``analytic_cost`` and
    ``model_flops`` over every ``ARCHS`` x ``SHAPES`` pair, and
    ``parse_collectives`` on the HLO strings of tests/test_roofline.py;
  * the surrogate (``price`` of every valid smoke config of all six
    kernels on the six device models, ``best_modeled`` of each pair,
    ``SurrogateRunner`` traces) and the transfer functions, in a
    subprocess: the reference's ``repro.scenarios`` and ``repro.service``
    packages cannot be imported in this tree (their ``__init__``s reach
    the missing ``repro.hub.storage``), so the subprocess puts stand-in
    parent packages for them into ``sys.modules`` and imports the leaf
    modules ``surrogate`` and ``transfer`` directly. The stand-ins never
    enter the pytest process.

The reference's 16 tests of ``tests/test_scenarios.py`` are ported below
them with the same assertions; the live row is the live device's label
(``"cpu"`` here, with ``device="cpu"``) where the reference's was
``cpu_interpret``. Two of them take gemm where the reference took ssd:
they need a kernel whose smoke shape is another hub entry than its
default, and a framework kernel's hub default is its smoke shape
(``hub_default_problem``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.core.budget import Budget
from repro_torch.core.cache import CachedResult, CacheFile
from repro_torch.core.devices import DEVICES_BY_NAME
from repro_torch.core.searchspace import SearchSpace
from repro_torch.core.tunable import tunables_from_dict
from repro_torch.hub import storage
from repro_torch.kernels import KERNELS
from repro_torch.scenarios import (MODELED_CONFIDENCE, ScenarioMatrix,
                                   SurrogateRunner, best_modeled,
                                   gate_recorded, price, run_fleet, runnable)
from repro_torch.service import ConfigHub

REPO = Path(__file__).resolve().parents[1]
DEV = DEVICES_BY_NAME["tpu_v5e"]
TRACE_DEVICES = ("tpu_v5e", "tpu_lite_b")
TRACE_EVALS = 16
SHAPE_PAIRS = [
    ({"m": 2048, "n": 4096}, {"m": 4096, "n": 4096}),
    ({"m": 64}, {"m": 64, "n": 32}),
    ({"layout": "nchw", "m": 3}, {"layout": "nhwc", "m": 5}),
    ({"seq": 4096 * 256}, {"bh": 4, "seq": 256, "p": 32, "n": 32}),
    ({"m": 0, "k": 1.5}, {"m": 4, "k": 3}),
    ({"flag": True}, {"flag": 2}),
]
REF_TIMEOUT_S = 300

_REF_SCRIPT = textwrap.dedent("""
    import dataclasses, importlib, json, os, random, sys, types
    root = os.path.join(os.getcwd(), "src", "repro")
    import repro
    for name in ("scenarios", "service"):  # stand-in parents, this process only
        mod = types.ModuleType(f"repro.{name}")
        mod.__path__ = [os.path.join(root, name)]
        sys.modules[f"repro.{name}"] = mod
    sur = importlib.import_module("repro.scenarios.surrogate")
    tr = importlib.import_module("repro.service.transfer")
    from repro.core.budget import Budget, BudgetExhausted
    from repro.core.devices import HUB_DEVICES
    from repro.core.strategies import get_strategy
    from repro.kernels import KERNELS
    spec = json.loads(sys.argv[1])

    def result(r):
        return [r.status, r.time_s, list(r.times_s), r.compile_s,
                r.overhead_s]

    out = {"price": {}, "best": {}, "trace": {}, "transfer": []}
    for kernel, ks in KERNELS.items():
        space, wl = ks.space({}), ks.workload({})
        for dev in HUB_DEVICES:
            rows = []
            for cfg in space.valid_configs:
                p = sur.price(wl, space.as_dict(cfg), dev)
                rows.append([p.status, p.time_s, p.eff, p.reason,
                             None if p.roofline is None
                             else dataclasses.asdict(p.roofline)])
            out["price"][f"{kernel}/{dev.name}"] = rows
            mb = sur.best_modeled(kernel, None, dev.name)
            out["best"][f"{kernel}/{dev.name}"] = (
                None if mb is None else dataclasses.asdict(mb))
        for name in spec["trace_devices"]:
            dev = sur.DEVICES_BY_NAME[name]
            runner = sur.SurrogateRunner(space, wl, dev,
                                         Budget(max_evals=spec["evals"]))
            try:
                get_strategy("random_search").run(space, runner,
                                                  random.Random(0))
            except BudgetExhausted:
                pass
            out["trace"][f"{kernel}/{name}"] = {
                "trace": [[t, v, list(c)] for t, v, c in runner.trace],
                "memo": {k: result(o.result)
                         for k, o in runner.memo.items()}}
    out["best"]["none"] = [sur.best_modeled("nope", None, "tpu_v5e"),
                           sur.best_modeled("ssd", None, "gpu_x")]
    out["price_from_facts"] = [dataclasses.asdict(sur.price_from_facts(
        f, HUB_DEVICES[i % 6], eff)) for i, (f, eff) in
        enumerate(spec["facts"])]
    for a, b in spec["pairs"]:
        d = tr.shape_distance(a, b)
        out["transfer"].append([d, tr.shape_distance(b, a),
                                tr.transfer_confidence(d, False),
                                tr.transfer_confidence(d, True),
                                list(tr.donor_order_key(d, True, "m=1",
                                                        "devA"))])
    out["constants"] = [sur.MODEL_NAME, sur.MODELED_CONFIDENCE,
                        sur.GRID_LAUNCH_S, sur.MIN_EFF,
                        tr.UNSHARED_PENALTY, tr.CROSS_DEVICE_PENALTY]
    with open(sys.argv[2], "w") as f:
        json.dump(out, f)
""")
FACTS = [({"flops": 1e12, "bytes accessed": 3e9}, 1.0),
         ({"flops": 5e9, "bytes_accessed": 8e10}, 0.5),
         ({"flops": 0.0}, 1e-6)]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's surrogate and transfer outputs, from a subprocess."""
    out = tmp_path_factory.mktemp("scenarios_ref") / "ref.json"
    spec = {"trace_devices": TRACE_DEVICES, "evals": TRACE_EVALS,
            "pairs": SHAPE_PAIRS, "facts": FACTS}
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run([sys.executable, "-c", _REF_SCRIPT,
                           json.dumps(spec), str(out)], env=env, cwd=REPO,
                          capture_output=True, text=True,
                          timeout=REF_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out) as f:
        return json.load(f)


def _json_round(x):
    """What the subprocess's JSON made of a value (tuples become lists)."""
    return json.loads(json.dumps(x))


# ------------------------------------------------ against the reference
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_price_matches_reference(ref, kernel):
    spec = KERNELS[kernel]
    space, wl = spec.space({}), spec.workload({})
    for dev in DEVICES_BY_NAME.values():
        rows = []
        for cfg in space.valid_configs:
            p = price(wl, space.as_dict(cfg), dev)
            rows.append([p.status, p.time_s, p.eff, p.reason,
                         None if p.roofline is None
                         else dataclasses.asdict(p.roofline)])
        assert _json_round(rows) == ref["price"][f"{kernel}/{dev.name}"], \
            (kernel, dev.name)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_best_modeled_matches_reference(ref, kernel):
    for name in DEVICES_BY_NAME:
        mb = best_modeled(kernel, None, name)
        got = None if mb is None else dataclasses.asdict(mb)
        assert _json_round(got) == ref["best"][f"{kernel}/{name}"]


def test_best_modeled_unmodelable_matches_reference(ref):
    assert ref["best"]["none"] == [None, None]
    assert [best_modeled("nope", None, "tpu_v5e"),
            best_modeled("ssd", None, "gpu_x")] == [None, None]


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_surrogate_runner_trace_matches_reference(ref, kernel):
    import random

    from repro_torch.core.budget import BudgetExhausted
    from repro_torch.core.strategies import get_strategy
    spec = KERNELS[kernel]
    space, wl = spec.space({}), spec.workload({})
    for name in TRACE_DEVICES:
        runner = SurrogateRunner(space, wl, DEVICES_BY_NAME[name],
                                 Budget(max_evals=TRACE_EVALS))
        try:
            get_strategy("random_search").run(space, runner,
                                              random.Random(0))
        except BudgetExhausted:
            pass
        want = ref["trace"][f"{kernel}/{name}"]
        assert _json_round([[t, v, list(c)] for t, v, c in runner.trace]) \
            == want["trace"]
        assert _json_round({k: [o.result.status, o.result.time_s,
                                list(o.result.times_s), o.result.compile_s,
                                o.result.overhead_s]
                            for k, o in runner.memo.items()}) == want["memo"]


def test_price_from_facts_matches_reference(ref):
    from repro_torch.scenarios import price_from_facts
    devices = list(DEVICES_BY_NAME.values())
    got = [dataclasses.asdict(price_from_facts(f, devices[i % 6], eff))
           for i, (f, eff) in enumerate(FACTS)]
    assert _json_round(got) == ref["price_from_facts"]


def test_transfer_matches_reference(ref):
    from repro_torch.service import transfer as tr
    from repro_torch.scenarios import surrogate as sur
    got = []
    for a, b in SHAPE_PAIRS:
        d = tr.shape_distance(a, b)
        got.append([d, tr.shape_distance(b, a),
                    tr.transfer_confidence(d, False),
                    tr.transfer_confidence(d, True),
                    list(tr.donor_order_key(d, True, "m=1", "devA"))])
    assert _json_round(got) == ref["transfer"]
    assert ref["transfer"][0][0] == 0.49012907173427356
    assert [sur.MODEL_NAME, sur.MODELED_CONFIDENCE, sur.GRID_LAUNCH_S,
            sur.MIN_EFF, tr.UNSHARED_PENALTY, tr.CROSS_DEVICE_PENALTY] == \
        ref["constants"]


def _cells():
    from repro_torch.configs import ARCHS, SHAPES
    return [(a, s) for a in ARCHS for s in SHAPES]


@pytest.mark.parametrize("remat", ["full", "none"])
def test_roofline_functions_match_reference(remat):
    from repro import configs as ref_configs
    from repro.roofline import analysis as ref_rf
    from repro_torch import configs
    from repro_torch.roofline import analysis as rf
    for arch, shape in _cells():
        cfg, shp = configs.ARCHS[arch], configs.SHAPES[shape]
        rcfg, rshp = ref_configs.ARCHS[arch], ref_configs.SHAPES[shape]
        for n_chips in (1, 4, 256):
            ours = rf.analytic_cost(cfg, shp, remat, n_chips)
            assert ours == ref_rf.analytic_cost(rcfg, rshp, remat, n_chips)
            mf = rf.model_flops(cfg, shp)
            assert mf == ref_rf.model_flops(rcfg, rshp)
            a = rf.roofline(ours[0], ours[1], 1e9 * n_chips, n_chips,
                            mflops=mf)
            b = ref_rf.roofline(ours[0], ours[1], 1e9 * n_chips, n_chips,
                                mflops=mf)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (rf.PEAK_FLOPS, rf.HBM_BW, rf.LINK_BW) == \
        (ref_rf.PEAK_FLOPS, ref_rf.HBM_BW, ref_rf.LINK_BW)


@pytest.mark.parametrize("name,n_chips", [("SYNTH_HLO", 4),
                                          ("ALL_OPS_HLO", 8),
                                          ("START_HLO", 8)])
def test_parse_collectives_matches_reference(name, n_chips):
    import test_roofline

    from repro.roofline import analysis as ref_rf
    from repro_torch.roofline import analysis as rf
    hlo = getattr(test_roofline, name)
    ours = rf.parse_collectives(hlo, n_chips)
    theirs = ref_rf.parse_collectives(hlo, n_chips)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert sum(ours.counts.values()) > 0
    for t in ("s32[]", "(f32[8], bf16[128,64])", "c64[8]", ""):
        assert rf._max_element_bytes(t) == ref_rf._max_element_bytes(t)


# ------------------------------------- the reference's tests, ported
def ssd_smoke():
    spec = KERNELS["ssd"]
    prob = spec.problem({})
    return spec.space(prob), spec.workload(prob)


def synthetic_cache(kernel: str, device: str, values) -> CacheFile:
    """A tiny hand-made recorded cache under a real kernel name: config
    x=i scores ``values[i]`` (the service never re-derives the space)."""
    space = SearchSpace(tunables_from_dict(
        {"x": tuple(range(len(values)))}), name=f"{kernel}@{device}")
    results = {space.config_id(c): CachedResult("ok", float(v), (float(v),),
                                                0.1)
               for c, v in zip(space.valid_configs, values)}
    return CacheFile(kernel, device, space, results, {})


@pytest.fixture()
def ssd_root(tmp_path):
    """A hub holding one recorded entry: ssd's default shape on tpu_v5e."""
    root = str(tmp_path / "hub")
    storage.register_cache(root, synthetic_cache("ssd", "tpu_v5e",
                                                 [2.0, 1.0]))
    return root


def test_price_is_deterministic():
    space, wl = ssd_smoke()
    for cfg in space.valid_configs:
        d = space.as_dict(cfg)
        a, b = price(wl, d, DEV), price(wl, d, DEV)
        assert a == b
        if a.status == "ok":
            assert a.time_s > 0 and a.roofline is not None


def test_surrogate_runner_bit_identical_cached_results():
    space, wl = ssd_smoke()

    def sweep() -> dict:
        runner = SurrogateRunner(space, wl, DEV, Budget())
        return {space.config_id(c): runner.run(c).result
                for c in space.valid_configs}

    first, second = sweep(), sweep()
    assert first == second
    # bit-identical, not merely equal: the modeled tier's cacheability
    # and the replayability of surrogate-recorded caches both rest on it
    assert pickle.dumps(first) == pickle.dumps(second)
    assert any(r.status == "ok" for r in first.values())


def test_best_modeled_deterministic_with_provenance():
    a = best_modeled("ssd", None, "tpu_v5e")
    b = best_modeled("ssd", None, DEV)  # device by name or by model
    assert a == b
    assert a.value > 0 and a.n_ok <= a.n_valid
    prov = a.provenance()
    assert prov["model"] == "roofline-v1"
    assert prov["device_model"] == "tpu_v5e"
    assert prov["dominant"] in ("compute", "memory")
    assert best_modeled("nope", None, "tpu_v5e") is None
    assert best_modeled("ssd", None, "gpu_x") is None


def test_surrogate_ranks_match_recorded_cache(tmp_path):
    """The acceptance bar: the surrogate's ranking of a kernel's configs
    correlates (Spearman >= 0.5) with a recorded cache's times."""
    from scipy.stats import spearmanr

    from repro_torch.api import Tuner
    out = str(tmp_path / "ssd.json.gz")
    with Tuner(workers=1) as tuner:
        run = tuner.record("ssd", runner="costmodel", device="tpu_v5e",
                           out=out, bruteforce=True)
    cache = run.cache
    _, wl = ssd_smoke()
    recorded, modeled = [], []
    for cid, res in cache.results.items():
        if res.status != "ok":
            continue
        cfg = cache.space.as_dict(cache.space.config_from_id(cid))
        p = price(wl, cfg, DEV)
        assert p.status == "ok"
        recorded.append(res.time_s)
        modeled.append(p.time_s)
    assert len(recorded) >= 10
    rho = float(spearmanr(recorded, modeled).correlation)
    assert rho >= 0.5, f"surrogate rank correlation too weak: {rho:.3f}"


def test_tier_order_exact_transfer_modeled_cold(ssd_root):
    hub = ConfigHub(ssd_root)
    # exact: the recorded default shape wins over everything
    assert hub.lookup("ssd", None, "tpu_v5e").status == "exact"
    # transfer: a close shape keeps the donor (confidence >= the
    # modeled-tier threshold), even though ssd is modelable
    r = hub.lookup("ssd", {"seq": 2048}, "tpu_v5e")
    assert r.status == "transfer" and r.confidence >= MODELED_CONFIDENCE
    # modeled: a registry kernel with nothing recorded on a known device
    m = hub.lookup("flash_attention", None, "tpu_v4")
    assert m.status == "modeled" and m.found
    assert m.confidence == pytest.approx(MODELED_CONFIDENCE)
    assert m.best_config is not None and m.best_value > 0
    assert m.model["model"] == "roofline-v1"
    assert m.model["device_model"] == "tpu_v4"
    # cold: unknown kernel, or a known kernel on an unknown device
    assert hub.lookup("nope", None, "tpu_v5e").status == "cold"
    assert hub.lookup("flash_attention", None, "gpu_x").status == "cold"
    assert hub.stats()["lookups"]["modeled"] == 1


def test_low_confidence_transfer_demoted_to_modeled(ssd_root):
    # the only donor is wildly far in shape; its confidence falls below
    # the threshold, so the analytic prior outranks it
    hub = ConfigHub(ssd_root)
    r = hub.lookup("ssd", {"seq": 4096 * 256}, "tpu_v5e")
    assert r.status == "modeled"
    assert r.confidence == pytest.approx(MODELED_CONFIDENCE)


def test_unmodelable_kernel_keeps_low_confidence_transfer(tmp_path):
    # a kernel outside the registry cannot be priced: the far donor is
    # still the best available answer
    root = str(tmp_path / "hub")
    storage.register_cache(root, synthetic_cache("toy", "devA", [1.0]),
                           problem={"m": 4})
    hub = ConfigHub(root)
    r = hub.lookup("toy", {"m": 4 * 4096}, "devA")
    assert r.status == "transfer" and r.confidence < MODELED_CONFIDENCE


def test_modeled_answers_cached_and_picklable(ssd_root):
    hub = ConfigHub(ssd_root)
    r1 = hub.lookup("flash_attention", None, "tpu_v4")
    r2 = hub.lookup("flash_attention", None, "tpu_v4")
    assert (r1.best_config, r1.best_value) == (r2.best_config, r2.best_value)
    assert hub.stats()["modeled_cached"] == 1
    j = r1.to_json()
    assert j["tier"] == "modeled" and j["model"]["n_valid"] >= j["model"]["n_ok"]
    # workers receive the cached surrogate argmin, not locks or threads
    clone = pickle.loads(pickle.dumps(hub))
    r3 = clone.lookup("flash_attention", None, "tpu_v4")
    assert r3.status == "modeled" and r3.best_config == r1.best_config


def test_register_invalidates_modeled_cache(ssd_root):
    hub = ConfigHub(ssd_root)
    assert hub.lookup("flash_attention", None, "tpu_v5e").status == "modeled"
    fa_default = dict(storage.hub_default_problem("flash_attention"))
    storage.register_cache(ssd_root,
                           synthetic_cache("flash_attention", "tpu_v5e",
                                           [4.0, 3.0]))
    hub.invalidate(kernel="flash_attention")
    r = hub.lookup("flash_attention", fa_default, "tpu_v5e")
    assert r.status == "exact" and r.best_value == 3.0


def test_matrix_enumerates_deterministically():
    mk = lambda: ScenarioMatrix(kernels=("gemm", "ssd"),  # noqa: E731
                                devices=("tpu_v5e", "cpu"))
    keys = [s.key for s in mk()]
    assert keys == [s.key for s in mk()]
    assert len(set(keys)) == len(keys) == len(mk())
    with pytest.raises(ValueError):
        ScenarioMatrix(kernels=("nope",))


def test_coverage_tiers_counts_and_best(tmp_path):
    # gemm, whose smoke shape is another hub entry than its default: the
    # reference's test used ssd, but ssd's hub default is its smoke shape
    # (``hub_default_problem``: the shape the hub records for a framework
    # kernel), so ssd has no smoke row (test_framework_kernels_one_shape)
    root = str(tmp_path / "hub")
    storage.register_cache(root, synthetic_cache("gemm", "tpu_v5e",
                                                 [2.0, 1.0]))
    hub = ConfigHub(root)
    m = ScenarioMatrix(kernels=("gemm",), devices=("tpu_v5e", "cpu"))
    report = m.coverage(hub, with_best=True)
    tiers = {(r.scenario.shape, r.scenario.device): r.tier
             for r in report.rows}
    assert tiers == {("default", "tpu_v5e"): "recorded",
                     ("default", "cpu"): "cold",
                     ("smoke", "tpu_v5e"): "modeled",
                     ("smoke", "cpu"): "cold"}
    assert report.counts() == {"recorded": 1, "modeled": 1, "cold": 2}
    assert list(report.recorded_best().values()) == [1.0]
    j = report.to_json()
    assert j["counts"] == report.counts() and len(j["rows"]) == 4
    cell = j["matrix"]["gemm"]["tpu_v5e"]
    assert cell["recorded"] == 1 and cell["modeled"] == 1


def test_gate_recorded_failure_modes():
    base = {"a": 1.0, "b": 2.0}
    assert gate_recorded({"a": 1.0, "b": 2.0}, base) == []
    # within threshold, and brand-new coverage, both pass
    assert gate_recorded({"a": 1.19, "b": 2.0, "c": 9.9}, base) == []
    fails = gate_recorded({"a": 1.3}, base)
    assert len(fails) == 2
    assert any("absent" in f for f in fails)
    assert any("+30.0%" in f for f in fails)


def test_runnable_by_runner():
    scs = ScenarioMatrix(kernels=("gemm",),
                         devices=("tpu_v5e", "cpu")).scenarios()
    assert {s.device for s in scs if runnable(s, "live", device="cpu")} \
        == {"cpu"}
    for runner in ("costmodel", "surrogate"):
        assert {s.device for s in scs if runnable(s, runner)} == {"tpu_v5e"}


def test_fleet_records_then_resumes(tmp_path):
    # gemm: its smoke shape differs from its default (the reference's test
    # used ssd, whose smoke shape is its default in both packages)
    root = str(tmp_path / "hub")
    storage.register_cache(root, synthetic_cache("gemm", "tpu_v5e",
                                                 [2.0, 1.0]))
    matrix = ScenarioMatrix(kernels=("gemm",), devices=("tpu_v5e",))
    out1 = run_fleet(root, matrix=matrix, runner="costmodel", max_evals=4)
    # the registered default shape is skipped, the smoke shape recorded
    assert len(out1.covered) == 1 and len(out1.recorded) == 1
    r = ConfigHub(root).lookup("gemm", KERNELS["gemm"].problem({}),
                               "tpu_v5e")
    assert r.status == "exact"
    # re-run: the journal makes the sweep idempotent
    out2 = run_fleet(root, matrix=matrix, runner="costmodel", max_evals=4)
    assert not out2.recorded and len(out2.skipped) == 1
    assert out2.to_json()["skipped"] == list(out2.skipped)
    # changed recording settings must refuse to reuse the journal
    with pytest.raises(ValueError):
        run_fleet(root, matrix=matrix, runner="costmodel", max_evals=8)


def test_tuner_surrogate_exhaustive_and_strategy():
    from repro_torch.api import Tuner
    with Tuner(workers=1) as tuner:
        run = tuner.surrogate("ssd")
        assert run.mode == "surrogate" and run.best_config is not None
        rerun = tuner.surrogate("ssd")
        assert (run.best_config, run.best_value) \
            == (rerun.best_config, rerun.best_value)
        sampled = tuner.surrogate("ssd", strategy="random_search",
                                  max_evals=8)
        # the exhaustive argmin bounds any sampled result
        assert sampled.best_value >= run.best_value
        with pytest.raises(KeyError):
            tuner.surrogate("nope")


def test_hub_coverage_facade(ssd_root):
    from repro_torch.api import Hub
    report = Hub(ssd_root).coverage(kernels=("ssd",),
                                    devices=("tpu_v5e",))
    assert report.counts()["recorded"] == 1
    stats = Hub(ssd_root).stats(device="cpu")
    assert stats["coverage"]["counts"]["recorded"] >= 1


# ------------------------------------------------- the port's additions
def test_framework_kernels_one_shape(ssd_root):
    from repro_torch.scenarios import kernel_shapes
    for kernel in ("flash_attention", "ssd"):
        assert kernel_shapes(kernel) == {
            "default": KERNELS[kernel].module.SMOKE_PROBLEM}
    assert set(kernel_shapes("gemm")) == {"default", "smoke"}
    report = ScenarioMatrix(kernels=("ssd",),
                            devices=("tpu_v5e", "cpu")).coverage(
        ConfigHub(ssd_root))
    assert [(r.scenario.shape, r.tier) for r in report.rows] == [
        ("default", "recorded"), ("default", "cold")]


def test_live_row_is_the_live_device_label():
    from repro_torch.scenarios import live_device_label
    m = ScenarioMatrix(kernels=("hotspot",), device="cpu")
    assert m.devices[-1] == "cpu" == live_device_label("cpu")
    assert m.devices[:-1] == tuple(DEVICES_BY_NAME)
    keys = [s.key for s in m]
    assert keys[0] == "hotspot@tpu_v5e#h=4096,w=4096"
    # registry x shape x device order
    assert [(s.shape, s.device) for s in m][:2] == [
        ("default", "tpu_v5e"), ("default", "tpu_v4")]


def test_live_fleet_on_the_cpu(tmp_path):
    """A live fleet records the live row through the port's kernels (their
    plain versions here), registers it, resumes to nothing, and the
    coverage marks it recorded; the gate of a report against itself
    passes."""
    from repro_torch.kernels import hotspot
    root = str(tmp_path / "hub")
    storage.write_manifest(root, storage.new_manifest())
    matrix = ScenarioMatrix(kernels=("hotspot",), devices=("tpu_v5e", "cpu"),
                            shapes=("smoke",))
    launches = hotspot.launches
    out = run_fleet(root, matrix=matrix, runner="live", max_evals=4,
                    repeats=1, device="cpu")
    assert out.recorded == ("hotspot@cpu#h=64,w=128",)
    assert out.unrunnable == ("hotspot@tpu_v5e#h=64,w=128",)
    assert hotspot.launches == launches  # plain versions count nothing
    again = run_fleet(root, matrix=matrix, runner="live", max_evals=4,
                      repeats=1, device="cpu")
    assert again.skipped == out.recorded and not again.recorded
    hub = ConfigHub(root)
    report = matrix.coverage(hub, with_best=True)
    assert [r.tier for r in report.rows] == ["modeled", "recorded"]
    assert gate_recorded(report.recorded_best(), report.recorded_best()) \
        == []
    cache = storage.load_cache(root, "hotspot@cpu#h=64,w=128")
    assert cache.meta["runner"] == "live" and len(cache.results) == 4

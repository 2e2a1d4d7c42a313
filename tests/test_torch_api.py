"""The port's facade (``repro_torch.api``), ops facade and hub CLI verbs.

``Hub`` and ``Tuner`` are held against the reference's ``repro.api``
contract (``tests/test_api.py::test_empty_hub_selection_raises`` ported,
on a temporary root), ``describe_space`` and ``hyperparam_space_stats``
against the reference's run (equal except for compile times), and the
verbs ``spaces``, ``lookup``, ``serve``, ``scenarios``, ``fleet`` and
``hub`` through ``repro_torch.cli.main``. Everything runs on
``device="cpu"``; scores from the hub are bit-identical between the
torch engine (its budget scan's plain version here) and the numpy engine.
"""
from __future__ import annotations

import json
import os

import pytest
import torch
from _synth import parity_cache

from repro_torch.api import (Hub, Tuner, TuningRun, describe_space,
                             hyperparam_space_stats, lint)
from repro_torch.core.cache import CacheFile
from repro_torch.hub import HubError, storage


def port_cache(kernel: str, device: str, tmp_path, **kw) -> CacheFile:
    """``_synth.parity_cache`` as the port loads it, under a hub name."""
    path = str(tmp_path / f"{kernel}@{device}.json.gz")
    parity_cache(name=kernel, **kw).save(path)
    c = CacheFile.load(path)
    return CacheFile(kernel, device, c.space, c.results, {})


@pytest.fixture()
def hub_root(tmp_path):
    """Two synthetic spaces on two train devices and one test device."""
    root = str(tmp_path / "hub")
    for kernel, n_a in (("synA", 24), ("synB", 16)):
        for device in ("tpu_v5e", "tpu_v4", "tpu_v6e"):
            storage.register_cache(root, port_cache(kernel, device, tmp_path,
                                                    n_a=n_a))
    return root


# ----------------------------------------------------------------- Tuner
def test_empty_hub_selection_raises(hub_root, tmp_path):
    with pytest.raises(ValueError):
        Tuner(kernels=["no_such_kernel"], hub_root=hub_root).scorers
    with pytest.raises(HubError):  # a ValueError too: no hub at all
        Tuner(hub_root=str(tmp_path / "none"), device="cpu").scorers


def test_speedup_none_without_wall():
    assert TuningRun(mode="simulate", strategy="x").speedup is None


def test_tuner_resolves_the_hub_split(hub_root):
    tuner = Tuner(hub_root=hub_root, device="cpu")
    assert [(c.kernel, c.device) for c in tuner._resolve_caches()] == [
        ("synA", "tpu_v4"), ("synA", "tpu_v5e"), ("synB", "tpu_v4"),
        ("synB", "tpu_v5e")]
    test = Tuner(hub_root=hub_root, split="test", device="cpu")
    assert {c.device for c in test._resolve_caches()} == {"tpu_v6e"}
    explicit = Tuner(hub_root=hub_root, devices=["tpu_v6e"],
                     kernels=["synB"], device="cpu")
    assert len(explicit._resolve_caches()) == 1


@pytest.mark.parametrize("strategy", ["random_search", "genetic_algorithm"])
def test_simulate_from_the_hub_torch_equals_numpy(hub_root, strategy):
    runs = {}
    for engine in ("torch", "vectorized"):
        with Tuner(hub_root=hub_root, engine=engine, repeats=3,
                   device="cpu") as tuner:
            runs[engine] = tuner.simulate(strategy)
    torch_run, numpy_run = runs["torch"], runs["vectorized"]
    assert torch_run.mode == "simulate" and torch_run.n_evaluated == 1
    assert torch_run.score == numpy_run.score
    assert torch_run.report.per_space_score == \
        numpy_run.report.per_space_score
    assert torch_run.simulated_seconds == numpy_run.simulated_seconds
    assert torch_run.speedup and torch_run.speedup > 1


def test_hypertune_and_meta_from_the_hub(hub_root, tmp_path):
    with Tuner(hub_root=hub_root, repeats=2, device="cpu") as tuner:
        run = tuner.hypertune("greedy_ils",
                              journal=str(tmp_path / "j.jsonl"))
        assert run.mode == "hypertune" and run.best_hyperparams is not None
        assert run.n_evaluated == len(run.hypertuning.results)
        meta = tuner.meta("greedy_ils", "random_search", extended=False,
                          max_hp_evals=3)
        assert meta.mode == "meta" and meta.n_evaluated <= 3


def test_record_live_on_the_cpu(tmp_path):
    out = str(tmp_path / "rec" / "hotspot.json.gz")
    with Tuner(device="cpu", seed=1) as tuner:
        run = tuner.record("hotspot", max_evals=4, repeats=1, out=out)
    assert run.mode == "record" and run.cache_path == out
    assert run.cache.device == "cpu" and run.cache.meta["runner"] == "live"
    assert run.n_evaluated == 4 and run.best_config is not None
    assert run.simulated_seconds == pytest.approx(
        sum(r.charge_s for r in run.cache.results.values()))
    assert os.path.exists(out)


def test_record_model_runners_name_their_device_model(tmp_path):
    with Tuner() as tuner:
        with pytest.raises(ValueError, match="device model"):
            tuner.record("ssd", runner="costmodel",
                         out=str(tmp_path / "a.json.gz"))
        run = tuner.record("ssd", runner="surrogate", device="tpu_v4",
                           max_evals=8, out=str(tmp_path / "b.json.gz"))
        with pytest.raises(KeyError):
            tuner.record("nope", runner="costmodel", device="tpu_v4")
    assert run.cache.meta["runner"] == "surrogate"
    assert run.cache.device == "tpu_v4" and run.n_evaluated == 8
    # surrogate results are one deterministic observation each
    assert all(len(r.times_s) == 1 for r in run.cache.results.values()
               if r.status == "ok")


def test_tuner_lookup_goes_through_the_hub(hub_root):
    tuner = Tuner(hub_root=hub_root)
    r = tuner.lookup("synA", None, "tpu_v5e")
    assert r.status == "exact" and r.source == "synA@tpu_v5e"
    assert tuner.lookup("synA", None, "tpu_lite_b").status == "transfer"
    assert tuner.hub.service().stats()["lookups"]["exact"] == 1


def test_space_stats_match_the_reference(hub_root):
    from repro.api import describe_space as ref_describe
    from repro.api import hyperparam_space_stats as ref_hp_stats
    from repro.core.cache import CacheFile as RefCacheFile

    def strip(st):
        return {k: v for k, v in st.items() if k != "compile_seconds"}

    tuner = Tuner(hub_root=hub_root, kernels=["synA"], devices=["tpu_v4"])
    ours = tuner.space_stats()
    path = os.path.join(hub_root, "synA@tpu_v4.json.gz")
    assert [strip(s) for s in ours] == \
        [strip(ref_describe(RefCacheFile.load(path).space))]
    assert strip(describe_space(tuner._resolve_caches()[0].space)) == \
        strip(ours[0])
    for extended in (False, True):
        assert [strip(s) for s in hyperparam_space_stats(extended)] == \
            [strip(s) for s in ref_hp_stats(extended)]


def test_lint_api_is_clean():
    result = lint()
    assert result.ok, [f"{f.rule}:{f.path}:{f.line}"
                       for f in result.findings]


# ------------------------------------------------------------------- Hub
def test_hub_facade_build_verify_and_caches(tmp_path):
    root = str(tmp_path / "hub")
    hub = Hub.build(root, progress=None, kernels=("hotspot",),
                    devices=("tpu_v5e", "tpu_v6e"))
    assert hub.verify() == {}
    assert sorted(hub.load()) == [("hotspot", "tpu_v5e"),
                                  ("hotspot", "tpu_v6e")]
    assert [c.device for c in hub.caches(split="train")] == ["tpu_v5e"]
    assert [c.device for c in hub.caches(split="test")] == ["tpu_v6e"]
    train, test = hub.train_test_caches()
    assert len(train) == len(test) == 1
    manifest = hub.manifest
    manifest["files"]["hotspot@tpu_v6e"]["sha256"] = "f" * 64
    storage.write_manifest(root, manifest)
    with pytest.raises(HubError, match="failed verification"):
        hub.verify()
    assert hub.verify(strict=False) == {"hotspot@tpu_v6e": "sha256 mismatch"}


def test_hub_register_invalidates_the_service(hub_root, tmp_path):
    hub = Hub(hub_root)
    before = hub.lookup("synA", None, "tpu_v5e").best_value
    better = port_cache("synA", "tpu_v5e", tmp_path, n_a=24)
    key = next(iter(better.results))
    better.results[key] = type(better.results[key])(
        "ok", before / 2, (before / 2,), 0.1)
    assert hub.register(better) == "synA@tpu_v5e"
    assert hub.lookup("synA", None, "tpu_v5e").best_value == before / 2


def test_hub_stats_and_coverage(hub_root):
    hub = Hub(hub_root)
    st = hub.stats(device="cpu")
    assert st["entries"] == 6 and st["kernels"] == ["synA", "synB"]
    assert st["devices"] == ["tpu_v4", "tpu_v5e", "tpu_v6e"]
    assert st["n_configs"] == 3 * (24 * 4 * 2 + 16 * 4 * 2)
    # the registry's kernels: nothing recorded, so the device models are
    # modeled and the live row ("cpu") cold
    counts = st["coverage"]["counts"]
    assert counts["recorded"] == 0 and counts["cold"] > 0
    # the coverage created the service; it answered nothing yet
    assert sum(st["service"]["lookups"].values()) == 0
    hub.lookup("synA", None, "tpu_v4")
    assert hub.stats(device="cpu")["service"]["lookups"]["exact"] == 1


# -------------------------------------------------------------- kernels
def test_ops_facade_reexports_every_kernel():
    from repro_torch.kernels import (convolution, dedispersion,
                                     flash_attention, gemm, hotspot, ops,
                                     ssd)
    assert ops.gemm is gemm.gemm and ops.gemm_plain is gemm.gemm_plain
    assert ops.conv2d is convolution.conv2d
    assert ops.hotspot_plain is hotspot.hotspot_plain
    assert ops.make_delays is dedispersion.make_delays
    assert ops.attention_plain is flash_attention.attention_plain
    assert ops.ssd_scan is ssd.ssd_scan and ops.ssd_plain is ssd.ssd_plain
    assert len(ops.__all__) == 13
    g = torch.Generator().manual_seed(0)
    a, b, c = (torch.randn(32, 32, generator=g) for _ in range(3))
    assert torch.equal(ops.gemm(a, b, c, block_m=32, block_n=64, block_k=32),
                       ops.gemm_plain(a, b, c))


# ------------------------------------------------------------ the verbs
def test_cli_hub_build_info_verify_stats(tmp_path, capsys):
    from repro_torch.cli import main
    root = str(tmp_path / "hub")
    assert main(["hub", "build", "--root", root, "--device", "cpu",
                 "--kernels", "hotspot,ssd", "--devices", "tpu_lite_b"]) == 0
    assert "(2 entries)" in capsys.readouterr().out
    assert main(["hub", "verify", "--root", root]) == 0
    assert "all 2 entries verified" in capsys.readouterr().out
    assert main(["hub", "info", "--root", root]) == 0
    info = json.loads(capsys.readouterr().out)
    assert sorted(info["files"]) == ["hotspot@tpu_lite_b", "ssd@cpu"]
    assert main(["hub", "stats", "--root", root, "--device", "cpu"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["coverage"]["counts"]["recorded"] == 2
    os.remove(os.path.join(root, info["files"]["ssd@cpu"]["path"]))
    assert main(["hub", "verify", "--root", root]) == 1
    assert "FAIL ssd@cpu: missing file" in capsys.readouterr().out


def test_cli_lookup_exit_codes_and_live_alias(hub_root, capsys):
    from repro_torch.cli import main
    assert main(["lookup", "--hub-root", hub_root, "--kernel", "synA"]) == 0
    assert "exact" in capsys.readouterr().out
    assert main(["lookup", "--hub-root", hub_root, "--kernel", "nope",
                 "--device", "cpu", "--json"]) == 3
    assert json.loads(capsys.readouterr().out)["status"] == "cold"
    # "cpu" names the live device's label; a warm start records it live
    assert main(["lookup", "--hub-root", hub_root, "--kernel", "hotspot",
                 "--device", "cpu", "--problem", "h=64,w=128",
                 "--warm-start", "--warm-max-evals", "2", "--wait", "300",
                 "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["device"] == "cpu" and out["status"] == "exact"
    assert out["source"] == "hotspot@cpu#h=64,w=128"


def test_cli_serve_reads_stdin(hub_root, capsys, monkeypatch):
    import io

    from repro_torch.cli import main
    lines = [json.dumps({"kernel": "synA", "device": "tpu_v4"}),
             json.dumps([{"kernel": "synB"}, {"kernel": "nope"}])]
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(lines) + "\n"))
    assert main(["serve", "--hub-root", hub_root, "--device", "cpu"]) == 0
    out = [json.loads(line) for line in
           capsys.readouterr().out.splitlines()]
    assert [r["status"] for r in out] == ["exact", "exact", "cold"]
    assert out[1]["device"] == "tpu_v5e"  # the reference's default device


def test_cli_scenarios_out_and_gate(hub_root, tmp_path, capsys):
    from repro_torch.cli import main
    cov = str(tmp_path / "cov.json")
    args = ["scenarios", "--hub-root", hub_root, "--device", "cpu",
            "--kernels", "hotspot"]
    assert main(args + ["--out", cov]) == 0
    assert "14 scenarios: 0 recorded, 12 modeled, 2 cold" in \
        capsys.readouterr().out
    report = json.load(open(cov))
    assert report["format"] == "repro-scenario-coverage-v1"
    assert [r["device"] for r in report["rows"]][-1] == "cpu"
    assert main(args + ["--gate", cov]) == 0
    assert "gate ok" in capsys.readouterr().out
    # a baseline that recorded a triple the hub no longer holds fails
    report["rows"][0].update(tier="recorded", best_value=1.0)
    json.dump(report, open(cov, "w"))
    assert main(args + ["--gate", cov]) == 1
    assert "now absent" in capsys.readouterr().out


def test_cli_fleet_costmodel_then_resume(tmp_path, capsys):
    from repro_torch.cli import main
    root = str(tmp_path / "hub")
    storage.write_manifest(root, storage.new_manifest())
    args = ["fleet", "--hub-root", root, "--kernels", "ssd", "--devices",
            "tpu_v5e,tpu_v4", "--max-evals", "4", "--quiet", "--json"]
    assert main(args) == 0
    first = json.loads(capsys.readouterr().out)
    assert len(first["recorded"]) == 2 and not first["skipped"]
    assert main(args) == 0
    second = json.loads(capsys.readouterr().out)
    assert second["skipped"] == first["recorded"]
    assert main(["lookup", "--hub-root", root, "--kernel", "ssd",
                 "--device", "tpu_v4", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["status"] == "exact"


def test_cli_spaces(hub_root, capsys):
    from repro_torch.cli import main
    assert main(["spaces", "--hub-root", hub_root, "--kernels", "synB"]) == 0
    out = capsys.readouterr().out
    assert "synB@tpu_v4" in out and "synB@tpu_v5e" in out
    assert "hp[genetic_algorithm]" in out

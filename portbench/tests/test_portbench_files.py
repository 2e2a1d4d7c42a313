"""Every cell, configuration and metric of BENCHMARK.json loads by name,
and the files keep to the benchmark's contract: each configuration by
the rules of its kind, each workload by those of its driver."""
import copy
import json
import pathlib
import re

import pytest

from portbench import harness
from portbench.reference import budget_rule
from portbench.reference.recording import Recording, sha256_of

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = {c["name"]: c for c in BENCH["configs"]}
FIXTURE = "portbench/tests/serve_fixture/"

# a configuration file without "kind" is a recording
RECORDING_KEYS = {"recording", "sha256", "kernel", "problem", "configs",
                  "budget_s", "reduced"}
MODEL_KEYS = {"kind", "arch", "source", "vocab_size", "published",
              "reduced", "assumed", "deployment", "reference", "flops"}
# the catalog's keys and the port's ArchConfig fields that they give; a
# model file may read a key otherwise under "arch_fields" (granite's
# intermediate_size is an expert's width), and carries at least MUST_CARRY
ARCH_FIELDS = {
    "num_hidden_layers": "n_layers", "hidden_size": "d_model",
    "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
    "head_dim": "d_head", "intermediate_size": "d_ff", "vocab_size": "vocab",
    "num_local_experts": "n_experts", "num_experts": "n_experts",
    "num_experts_per_tok": "top_k", "moe_intermediate_size": "d_ff_expert",
    "mamba_d_state": "ssm_state", "mamba_n_heads": "ssm_heads",
    "n_mamba_heads": "ssm_heads", "mamba_d_head": "ssm_d_head",
    "mamba_headdim": "ssm_d_head", "mamba_expand": "ssm_expand",
    "mamba_d_conv": "conv_width", "mamba_chunk_size": "ssm_chunk",
    "chunk_size": "ssm_chunk", "rope_theta": "rope_theta",
    "sliding_window": "window"}
MUST_CARRY = ("num_hidden_layers", "hidden_size", "vocab_size")
# keys that name a width, which a cut may never change
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head)_?"
                   r"(size|dim)|_dim$|_rank$|expand|per_tok|d_model|d_ff"
                   r"|d_head|d_state")
# workload keys by driver: (required, optional)
WORKLOAD_BASE = {"config", "traffic", "driver", "why"}
DRIVER_KEYS = {
    "free_run": ({"strategy", "runs", "generations"}, {"hyperparams"}),
    "serve": ({"batch", "prompt_len", "new_tokens"}, set()),
}
COUNTS = {"runs", "generations", "batch", "prompt_len", "new_tokens"}


def recording_problems(entry: dict, cfg: dict, root: pathlib.Path) -> list:
    """What keeps a recording configuration from its rules: the frozen
    recording's sha256 and budget are the file's, it is the space the
    file says, and nothing is reduced."""
    missing = RECORDING_KEYS - set(cfg)
    if missing or "kind" in cfg:
        return [f"keys: missing {sorted(missing)}, kind {cfg.get('kind')}"]
    out = []
    if not cfg["recording"].startswith("portbench/data/"):
        return [f"recording {cfg['recording']} is not under portbench/data/"]
    path = root / cfg["recording"]
    if not path.is_file() or sha256_of(str(path)) != cfg["sha256"]:
        return [f"{cfg['recording']}: missing, or its sha256 is not the "
                f"file's"]
    rec = Recording.load(str(path))
    if rec.kernel != cfg["kernel"] or rec.n_valid != cfg["configs"]:
        out.append("the recording's kernel or config count differs")
    if rec.meta["problem"] != cfg["problem"]:
        out.append("the recording's problem differs")
    if budget_rule.budget_seconds(rec.kernel, rec.device, rec.time_s,
                                  rec.charge_s) != cfg["budget_s"]:
        out.append("budget_s is not the budget rule's")
    if not cfg["reduced"] == entry["reduced"] == []:
        out.append("a recording reduces nothing")
    return out


def model_problems(entry: dict, cfg: dict, root: pathlib.Path,
                   folder: str = "portbench/reference/") -> list:
    """What keeps a model configuration from its rules: the port knows
    its ``arch``, and every size the file gives is the port's for it;
    its source and ``reduced`` are BENCHMARK.json's; each reduced key,
    and no width, has its published value beside it; its ``reference``
    and ``flops`` are files under ``folder`` with their entry points."""
    missing = MODEL_KEYS - set(cfg)
    if missing or cfg["kind"] != "model":
        return [f"keys: missing {sorted(missing)}, kind {cfg.get('kind')}"]
    from repro_torch.configs import get_config
    out = []
    try:
        arch = get_config(cfg["arch"])
    except KeyError:
        arch = None
        out.append(f"the port has no arch {cfg['arch']!r}")
    out += [f"no {key}" for key in MUST_CARRY if key not in cfg]
    fields = {**ARCH_FIELDS, **cfg.get("arch_fields", {})}
    for key, field in fields.items():
        if arch is None or key not in cfg:
            continue
        if not hasattr(arch, field):
            out.append(f"{key}: the port's config has no field {field}")
        elif getattr(arch, field) != cfg[key]:
            out.append(f"{key} {cfg[key]!r} is not the port's {field} "
                       f"{getattr(arch, field)!r}")
    if cfg["source"] != entry["source"]:
        out.append("source is not BENCHMARK.json's")
    if cfg["reduced"] != entry["reduced"]:
        out.append("reduced is not BENCHMARK.json's")
    if set(cfg["published"]) != set(cfg["reduced"]):
        out.append("published does not give exactly the reduced keys")
    for key in cfg["reduced"]:
        if WIDTH.search(key):
            out.append(f"{key} is a width: no cut may change it")
        if cfg.get(key) == cfg["published"].get(key):
            out.append(f"{key} is listed as reduced but is as published")
    if not (isinstance(cfg["assumed"], dict) and cfg["deployment"]):
        out.append("assumed is a dict and deployment says something")
    for key, entry_point in (("reference", "judge"), ("flops", "call_flops")):
        rel = cfg[key]
        if not (rel.startswith(folder) and rel.endswith(".py")
                and (root / rel).is_file()):
            out.append(f"{key} {rel} is no .py file under {folder}")
            continue
        mod = harness.load_module(root / rel, f"check_{key}")
        if not callable(getattr(mod, entry_point, None)):
            out.append(f"{rel} has no {entry_point}()")
    return out


def config_problems(entry: dict, root: pathlib.Path = ROOT, **kw) -> list:
    cfg = json.loads((root / entry["file"]).read_text())
    if not entry["file"].startswith("portbench/"):
        return [f"{entry['file']} is not under portbench/"]
    check = model_problems if "kind" in cfg else recording_problems
    return check(entry, cfg, root, **kw)


def workload_problems(wl: dict) -> list:
    """Keys the workload's driver needs, and no other."""
    if wl.get("driver") not in DRIVER_KEYS:
        return [f"no driver {wl.get('driver')!r}"]
    need, may = DRIVER_KEYS[wl["driver"]]
    out = []
    if not need <= set(wl):
        out.append(f"missing {sorted(need - set(wl))}")
    if set(wl) - WORKLOAD_BASE - need - may:
        out.append(f"unknown {sorted(set(wl) - WORKLOAD_BASE - need - may)}")
    for key in COUNTS & set(wl):
        if not (isinstance(wl[key], int) and wl[key] > 0):
            out.append(f"{key} is a positive whole number")
    return out


def test_top_level_keys_and_paths():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_bounds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + list(CONFIGS)
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", [])) <= set(CELLS)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = harness.load_cell(ROOT, cell)
    assert c.chips == 1
    wl = c.workload
    assert (harness.PKG / "drivers" / f"{wl['driver']}.py").is_file()
    for m in c.end_to_end:
        assert (harness.PKG / "end_to_end" / f"{m['name']}.py").is_file()
    for m in c.per_layer:
        assert (harness.PKG / "metrics" / f"{m['name']}.py").is_file()
    assert workload_problems(wl) == []
    # how many calls are judged and traced is the harness's, not a cell's
    assert not {"check_calls", "trace_calls"} & set(wl)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_file_matches_its_recording(name):
    """Each configuration keeps to the rules of its kind (both accepted
    ones are recordings: frozen sha256, the space, the budget)."""
    assert config_problems(CONFIGS[name]) == []


def fixture_model():
    entry = {"name": "zamba2-toy", "file": FIXTURE + "model_config.json",
             "source": "ArchConfig.tiny() of zamba2-1.2b, "
                       "src/repro_torch/configs/base.py",
             "reduced": ["vocab_size"]}
    cfg = json.loads((ROOT / entry["file"]).read_text())
    return entry, cfg


def test_fixture_model_config_passes_its_kinds_rules(toy_arch):
    entry, cfg = fixture_model()
    assert cfg["reduced"]
    assert model_problems(entry, cfg, ROOT, folder=FIXTURE) == []
    assert config_problems(entry, folder=FIXTURE) == []


@pytest.mark.parametrize("fault", [
    "no_arch", "unknown_arch", "reduced_not_the_entrys",
    "published_lacks_a_key", "width_reduced", "reduced_but_as_published",
    "reference_outside_folder", "flops_without_entry_point",
    "width_not_the_ports", "vocab_not_the_ports", "hidden_size_not_given",
    "read_as_no_field"])
def test_model_config_fails_its_kinds_rules(fault, toy_arch):
    entry, cfg = fixture_model()
    cfg = copy.deepcopy(cfg)
    if fault == "no_arch":
        del cfg["arch"]
    elif fault == "unknown_arch":
        cfg["arch"] = "no-such-model"
    elif fault == "reduced_not_the_entrys":
        entry = {**entry, "reduced": ["num_hidden_layers"]}
    elif fault == "published_lacks_a_key":
        del cfg["published"]["vocab_size"]
    elif fault == "width_reduced":
        cfg["reduced"] = entry["reduced"] = ["hidden_size"]
        cfg["published"] = {"hidden_size": 2048}
    elif fault == "reduced_but_as_published":
        cfg["published"]["vocab_size"] = cfg["vocab_size"]
    elif fault == "width_not_the_ports":
        # a file that gives published widths the port does not run
        cfg["hidden_size"], cfg["mamba_d_state"] = 2048, 64
    elif fault == "vocab_not_the_ports":
        cfg["vocab_size"] = cfg["published"]["vocab_size"] = 512
    elif fault == "hidden_size_not_given":
        del cfg["hidden_size"]
    elif fault == "read_as_no_field":
        cfg["arch_fields"] = {"intermediate_size": "d_ff_shared"}
    elif fault == "reference_outside_folder":
        cfg["reference"] = "portbench/drivers/serve.py"
    else:
        cfg["flops"] = FIXTURE + "toy_reference.py"
    assert model_problems(entry, cfg, ROOT, folder=FIXTURE) != []


@pytest.mark.parametrize("fault", ["sha256", "reduced", "kind", "budget"])
def test_recording_config_fails_its_kinds_rules(fault):
    entry = CONFIGS["hotspot-4096-h100"]
    cfg = json.loads((ROOT / entry["file"]).read_text())
    if fault == "sha256":
        cfg["sha256"] = "0" * 64
    elif fault == "reduced":
        cfg["reduced"] = ["configs"]
    elif fault == "kind":
        cfg["kind"] = "recording"
    else:
        cfg["budget_s"] *= 2
    assert recording_problems(entry, cfg, ROOT) != []


def test_every_config_keeps_to_its_kind():
    """Whatever configurations BENCHMARK.json holds, of either kind."""
    for entry in BENCH["configs"]:
        assert config_problems(entry) == [], entry["name"]


@pytest.mark.parametrize("wl, ok", [
    ({"driver": "free_run", "strategy": "pso", "runs": 8,
      "generations": 4}, True),
    ({"driver": "free_run", "strategy": "pso", "runs": 8}, False),
    ({"driver": "free_run", "strategy": "pso", "runs": 8, "generations": 4,
      "batch": 4}, False),
    ({"driver": "serve", "batch": 4, "prompt_len": 8192,
      "new_tokens": 16}, True),
    ({"driver": "serve", "batch": 4, "prompt_len": 8192, "new_tokens": 16,
      "generate_kwargs": {}}, False),
    ({"driver": "serve", "batch": 4, "prompt_len": 8192}, False),
    ({"driver": "serve", "batch": 4, "prompt_len": 8192, "new_tokens": 16,
      "runs": 8}, False),
    ({"driver": "serve", "batch": 0, "prompt_len": 8192,
      "new_tokens": 16}, False),
    ({"driver": "replay", "runs": 8}, False),
], ids=["free_run", "free_run_no_generations", "free_run_with_batch",
        "serve", "serve_with_generate_kwargs", "serve_no_new_tokens",
        "serve_with_runs", "serve_empty_batch", "unknown_driver"])
def test_workload_keys_by_driver(wl, ok):
    wl = {"config": "c", "traffic": "t", "why": "w", **wl}
    assert (workload_problems(wl) == []) is ok


def test_a_metric_file_for_every_metric_and_no_other():
    """Every metric has its reader. An end-to-end reader that no entry
    lists waits for its first cell (``BENCHMARK.json`` lists a metric
    only once a cell prints it, and that cell's PR appends the entry):
    it reads nothing in any accepted cell, and a driver's work unit
    feeds it."""
    e2e = {p.stem for p in (harness.PKG / "end_to_end").glob("*.py")}
    per = {p.stem for p in (harness.PKG / "metrics").glob("*.py")}
    listed = {m["name"] for m in BENCH["end_to_end"]}
    assert listed <= e2e
    waiting = [{"name": n, "unit": "u"} for n in sorted(e2e - listed)]
    for cell in CELLS:
        assert rates_read(cell_unit(cell), waiting) == set()
    fed = set().union(*(rates_read(work_unit(d.stem), waiting)
                        for d in (harness.PKG / "drivers").glob("*.py")))
    assert fed == e2e - listed
    assert per == {m["name"] for m in BENCH["per_layer"]}


def declared(cell: str) -> set:
    """The end-to-end metrics that BENCHMARK.json declares of ``cell``."""
    return {m["name"] for m in BENCH["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}


def rates_read(unit: str, bench_end_to_end: list) -> set:
    """The end-to-end metrics whose readers read a run whose calls' work
    is ``unit``."""
    run = harness.Run(12.5, [(1.0, 1.5, 10), (1.5, 2.0, 30)],
                      {"work_unit": unit, "flops_per_call": 1e12}, 0)
    return set(harness.read_metrics(run, bench_end_to_end, "end_to_end"))


def work_unit(driver: str) -> str:
    return harness.load_module(harness.PKG / "drivers" / f"{driver}.py",
                               driver).WORK_UNIT


def cell_unit(cell: str, root: pathlib.Path = ROOT) -> str:
    return work_unit(harness.load_cell(root, cell).workload["driver"])


@pytest.mark.parametrize("cell", CELLS)
def test_declared_metrics_are_the_ones_read(cell):
    """What each entry's list of cells declares is what the readers,
    asked in every cell, print there by the driver's work unit."""
    assert rates_read(cell_unit(cell), BENCH["end_to_end"]) == declared(cell)


def test_a_serve_cell_is_new_entries_and_files(tmp_path, monkeypatch):
    """A served cell's PR appends its configuration, its cell and the
    entries of the two served rates, each listing that cell, and adds
    files; it edits no entry. The cell then reads ``tokens_per_s``,
    ``step_mfu``, ``call_p90_ms`` and ``setup_s``, and every cell, the
    accepted ones with it, reads what the entries declare of it."""
    cell_name = "zamba2-toy.serve"
    bench = copy.deepcopy(BENCH)
    bench["configs"].append({"name": "zamba2-toy",
                             "file": FIXTURE + "model_config.json"})
    bench["workloads"].append({"name": cell_name,
                               "config": "zamba2-toy", "traffic": "serve",
                               "chips": 1})
    bench["end_to_end"] += [
        {"name": "tokens_per_s", "unit": "tokens/s", "better": "higher",
         "bound": 0.25, "source": "host_clock", "workloads": [cell_name]},
        {"name": "step_mfu", "unit": "%", "better": "higher",
         "bound": 0.25, "source": "host_clock", "workloads": [cell_name]}]
    assert bench["end_to_end"][:len(BENCH["end_to_end"])] == \
        BENCH["end_to_end"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / FIXTURE).mkdir(parents=True)
    (tmp_path / FIXTURE / "model_config.json").write_text(
        (ROOT / FIXTURE / "model_config.json").read_text())
    (tmp_path / "portbench" / "configs").symlink_to(
        ROOT / "portbench" / "configs")
    pkg = tmp_path / "pkg"
    (pkg / "workloads").mkdir(parents=True)
    (pkg / "workloads" / f"{cell_name}.json").write_text(json.dumps(
        {"config": "zamba2-toy", "traffic": "serve", "driver": "serve",
         "batch": 2, "prompt_len": 12, "new_tokens": 4}))
    for cell in CELLS:
        (pkg / "workloads" / f"{cell}.json").symlink_to(
            harness.PKG / "workloads" / f"{cell}.json")
    for folder in ("end_to_end", "drivers"):
        (pkg / folder).symlink_to(harness.PKG / folder)
    monkeypatch.setattr(harness, "PKG", pkg)
    cell = harness.load_cell(tmp_path, cell_name)
    assert cell.per_layer == []
    assert rates_read("tokens", cell.end_to_end) == {
        "tokens_per_s", "step_mfu", "call_p90_ms", "setup_s"}
    for name in CELLS + [cell_name]:
        assert rates_read(cell_unit(name, tmp_path), bench["end_to_end"]) \
            == {m["name"] for m in bench["end_to_end"]
                if "workloads" not in m or name in m["workloads"]}


def test_unknown_cell_is_refused():
    with pytest.raises(harness.CellError, match="no cell"):
        harness.load_cell(ROOT, "no.such.cell")

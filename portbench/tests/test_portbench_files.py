"""Every cell, configuration and metric of BENCHMARK.json loads by name,
and the files keep to the benchmark's contract."""
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
    assert wl["runs"] > 0 and wl["generations"] > 0
    # how many calls are judged and traced is the harness's, not a cell's
    assert not {"check_calls", "trace_calls"} & set(wl)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_file_matches_its_recording(name):
    """The frozen recording's sha256 and budget are the configuration
    file's, and it is the space the file says."""
    entry = CONFIGS[name]
    assert entry["file"].startswith("portbench/")
    cfg = json.loads((ROOT / entry["file"]).read_text())
    path = ROOT / cfg["recording"]
    assert cfg["recording"].startswith("portbench/data/")
    assert sha256_of(str(path)) == cfg["sha256"]
    rec = Recording.load(str(path))
    assert rec.kernel == cfg["kernel"] and rec.n_valid == cfg["configs"]
    assert rec.meta["problem"] == cfg["problem"]
    assert budget_rule.budget_seconds(rec.kernel, rec.device, rec.time_s,
                                      rec.charge_s) == cfg["budget_s"]
    assert cfg["reduced"] == entry["reduced"] == []


def test_a_metric_file_for_every_metric_and_no_other():
    e2e = {p.stem for p in (harness.PKG / "end_to_end").glob("*.py")}
    per = {p.stem for p in (harness.PKG / "metrics").glob("*.py")}
    assert e2e == {m["name"] for m in BENCH["end_to_end"]}
    assert per == {m["name"] for m in BENCH["per_layer"]}


def test_unknown_cell_is_refused():
    with pytest.raises(harness.CellError, match="no cell"):
        harness.load_cell(ROOT, "no.such.cell")

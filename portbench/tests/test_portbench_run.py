"""A whole run on the CPU at a tiny size: the harness's look for a card
is skipped, everything else runs as on the card; and the same run with
the timed path broken underneath, which the check has to catch."""
import time

import numpy as np
import pytest

from portbench import harness
from portbench.reference import compare
from portbench.reference import free_run_ref as ref
from portbench.reference.recording import Recording
from portbench.tools import faults

import pb_synth

STRATEGIES = ("genetic_algorithm", "pso", "differential_evolution",
              "random_search")


def run(tmp_path, strategy, seconds=0.3, **kw):
    cell = pb_synth.cell(tmp_path, strategy, **kw)
    return harness.run_cell(cell, 12345678901, seconds, False, "cpu",
                            time.perf_counter(), tmp_path)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_run_is_correct_and_complete(tmp_path, strategy):
    result = run(tmp_path, strategy)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"sim_evals_per_s", "call_p90_ms",
                                      "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["checks"] == {
        "runs_off": {"value": 0, "at_most": 0},
        "spend_gap_s": {"value": 0.0, "at_most": 0.0},
        "runs_compared": {"value": 2 * 8, "at_least": 1}}


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sampled_runs_of_a_large_call_match(tmp_path, strategy):
    """Where a call holds more runs than the check follows, the
    reference's sample of them equals the program's runs of the same
    index."""
    cell = pb_synth.cell(tmp_path, strategy, runs=600, generations=6)
    drv = harness.load_module(harness.PKG / "drivers" / "free_run.py",
                              "free_run").Driver(cell.config, cell.workload,
                                                 "cpu", tmp_path)
    drv.setup(7)
    got, _ = drv.call(123456789012)
    want = drv.reference([123456789012])[0]
    assert len(want["runs"]) == 512 < 600
    assert compare.compare(got, want) == {
        "runs_off": 0, "spend_gap_s": 0.0, "runs_compared": 512}


def test_a_check_that_compares_nothing_is_not_correct(tmp_path, monkeypatch):
    """No call kept, or no run compared: ``correct`` is false."""
    monkeypatch.setattr(harness, "CHECK_CALLS", 0)
    result = run(tmp_path, "random_search", seconds=0.05)
    assert result["correct"] is False
    assert result["checks"]["runs_compared"]["value"] == 0
    assert not harness.within(0, compare.LIMITS["runs_compared"])


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_planted_fault_is_not_correct(tmp_path, strategy, fault):
    with faults.FAULTS[fault](strategy):
        result = run(tmp_path, strategy, seconds=0.05)
    assert result["correct"] is False, (fault, result["checks"])


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_float32_control_fails(tmp_path, strategy):
    """The reference with its spend in float32, in the program's place,
    reads over the limits on every seed tried."""
    cell = pb_synth.cell(tmp_path, strategy, runs=16, generations=12)
    rec = Recording.load(str(tmp_path / cell.config["recording"]))
    kw = dict(runs=16, generations=12, max_seconds=cell.config["budget_s"],
              pick=np.arange(16), device="cpu")
    for seed in (1, 2, 3):
        want = ref.free_run(rec, strategy, seed=seed, **kw)
        low = ref.free_run(rec, strategy, seed=seed,
                           spend_dtype=np.float32, **kw)
        reading = compare.compare(low, want)
        assert not all(harness.within(reading[k], v)
                       for k, v in compare.LIMITS.items()), reading


def test_the_budget_cuts_runs(tmp_path):
    """At the configuration's budget some runs stop mid-campaign, so the
    spend cap and the freeze are on the compared path."""
    cell = pb_synth.cell(tmp_path, "genetic_algorithm", runs=16,
                         generations=30)
    rec = Recording.load(str(tmp_path / cell.config["recording"]))
    out = ref.free_run(rec, "genetic_algorithm", runs=16, seed=5,
                       generations=30, max_seconds=cell.config["budget_s"],
                       pick=np.arange(16), device="cpu")
    assert out["exhausted"].any()


def test_space_mismatch_stops_set_up(tmp_path):
    """A recording that lacks a config of the port's space is refused
    before any call."""
    pb_synth.write_recording(tmp_path / "rec-hotspot.json.gz", "hotspot",
                             pb_synth.HOT_SMALL, drop=1)
    with pytest.raises(RuntimeError, match="space lists 328 configs"):
        run(tmp_path, "pso")


def test_reservoir_keeps_k_drawn_from_the_seed():
    picks = []
    for _ in range(2):
        r = harness.Reservoir(2, 99)
        for i in range(50):
            r.offer(i, i)
        picks.append(r.items)
    assert picks[0] == picks[1] and len(set(picks[0])) == 2
    r = harness.Reservoir(3, 99)
    r.offer(0, "a")
    assert r.items == ["a"]

"""The program's spans and counters in a traced run (``portbench/phases.py``)
and their nine readers, on synthetic traces: each kernel put down to the
innermost span of its launch, the idle time inside the generations, the
counters, and nothing read where the program has no spans or counters."""
import sys
import types

import pytest

from portbench import harness, phases
from portbench.trace import SPAN, DeviceOp, Summary

G = 2
LEAF_US = 10.0
# the leaves of a generation in order, with the device time of the one
# kernel each launches
LEAVES = (("free_run.ask", 3.0), ("free_run.dedup", 2.0),
          ("free_run.scan", 2.0), ("free_run.tell", 5.0),
          ("free_run.commit", 1.0))
INIT_US, CALL_US = 4.0, 122.0
NEW = ("init_dev_ms_per_call", "ask_dev_ms_per_gen", "dedup_dev_ms_per_gen",
       "commit_dev_ms_per_gen", "tell_dev_ms_per_gen",
       "loop_idle_ms_per_gen", "to_host_ms_per_call", "live_run_share",
       "dead_gens_per_call")
OLD = ("launches_per_gen", "strategy_dev_ms_per_gen", "scan_roofline",
       "idle_share", "peak_mem_gib", "d2h_ms_per_call")
FACTS = {"runs": 1024, "generations": G, "popsize": 20, "n_valid": 10140,
         "scan_kernel": "budget_scan_kernel"}


def load(name):
    return harness.load_module(harness.PKG / "metrics" / f"{name}.py", name)


def kernel_at(t, name, us):
    """A launch at host time ``t`` and its kernel, 1 us later on the
    device."""
    return (t, t + 0.5, "cudaLaunchKernel"), DeviceOp(name, t + 1, t + 1 + us)


def call_at(o):
    """A call from ``o`` to ``o + CALL_US``: init (one kernel), G
    generations of the five leaves (one kernel each, launched 1 us into
    the leaf), to_host (one copy). Returns (launches, spans, ops)."""
    launches, spans, ops = [], [], []
    spans.append((o + 1, o + CALL_US - 1, "free_run"))
    spans.append((o + 1, o + 11, "free_run.init"))
    launch, op = kernel_at(o + 2, "fill", INIT_US)
    launches.append(launch)
    ops.append(op)
    t = o + 11
    for _ in range(G):
        spans.append((t, t + LEAF_US * len(LEAVES), "free_run.gen"))
        for leaf, us in LEAVES:
            spans.append((t, t + LEAF_US, leaf))
            name = ("budget_scan_kernel" if leaf == "free_run.scan"
                    else leaf.split(".")[1] + "_kernel")
            launch, op = kernel_at(t + 1, name, us)
            launches.append(launch)
            ops.append(op)
            t += LEAF_US
    spans.append((t, t + 9, "free_run.to_host"))
    ops.append(DeviceOp("Memcpy DtoH (Device -> Pageable)", t + 2, t + 8))
    return launches, spans, ops


def summary(with_spans=True, drop_launch=False):
    launches, spans, ops = [], [], []
    for o in (0.0, CALL_US):
        a, b, c = call_at(o)
        launches, spans, ops = launches + a, spans + b, ops + c
    if drop_launch:
        launches = launches[1:]
    host = launches + (spans if with_spans else [])
    return Summary(ops, host, [(0.0, CALL_US), (CALL_US, 2 * CALL_US)],
                   calls=2)


def run_of(trace):
    return harness.Run(1.0, [], FACTS, 2 ** 30, trace)


@pytest.fixture
def program(monkeypatch):
    """A stand-in for the program's module, with its counters."""
    mod = types.ModuleType(phases.PROGRAM)
    mod.calls, mod.run_gens, mod.live_run_gens, mod.dead_gens = (
        2, 2 * 1024 * G, 1536, 1)
    monkeypatch.setitem(sys.modules, phases.PROGRAM, mod)
    return mod


def test_host_spans_leave_the_device_readings_as_they_were():
    """The program's spans are host ranges only: the device operations,
    the busy time and the six accepted readings are those of the same
    trace without them."""
    a, b = summary(with_spans=False), summary()
    assert a.busy_s == b.busy_s and a.window_s == b.window_s
    assert a.kernels() == b.kernels()
    for name in OLD:
        assert load(name).read(run_of(a)) == load(name).read(run_of(b))
    assert load("launches_per_gen").read(run_of(b)) == pytest.approx(
        2 * (1 + G * len(LEAVES)) / (2 * G))


def test_idle_gaps_are_named_by_the_program_span_at_their_midpoint():
    """Where no host operation runs, a gap is named by the innermost
    program span, not by the call's; only the gap between the two calls
    (from the first one's copy to the second one's first kernel) lies
    outside ``free_run``."""
    gaps = summary().idle_by_host()
    assert gaps[SPAN] == pytest.approx(6e-6)
    assert gaps["free_run.tell"] == pytest.approx(2 * G * (LEAF_US - 5.0)
                                                  * 1e-6)
    assert set(gaps) - {SPAN} <= {"free_run", "free_run.init",
                                  "free_run.to_host", "free_run.gen"} | {
        leaf for leaf, _ in LEAVES}
    assert set(summary(with_spans=False).idle_by_host()) == {SPAN}


def test_each_kernel_is_put_down_to_the_innermost_span_of_its_launch():
    p = phases.of(summary())
    assert [n for _, n in p.by_kernel] == 2 * (
        ["free_run.init"] + G * [leaf for leaf, _ in LEAVES])
    assert p.at(11.5) == "free_run.ask"          # gen and ask start at 11
    assert p.at(0.5) is None and p.at(CALL_US - 0.5) is None
    assert p.at(CALL_US - 1.5) == "free_run"     # after to_host
    assert p.kernel_seconds("free_run.gen") is None


def test_the_readers_on_a_synthetic_trace(program):
    r = run_of(summary())
    got = {name: load(name).read(r) for name in NEW}
    per_gen = {leaf: us * 1e-3 for leaf, us in LEAVES}   # ms a generation
    assert got == pytest.approx({
        "init_dev_ms_per_call": INIT_US * 1e-3,
        "ask_dev_ms_per_gen": per_gen["free_run.ask"],
        "dedup_dev_ms_per_gen": per_gen["free_run.dedup"],
        "commit_dev_ms_per_gen": per_gen["free_run.commit"],
        "tell_dev_ms_per_gen": per_gen["free_run.tell"],
        # a generation's 50 us of host, 13 of them busy on the device
        "loop_idle_ms_per_gen": (5 * LEAF_US - 13.0) * 1e-3,
        "to_host_ms_per_call": 9e-3,
        "live_run_share": 100.0 * 1536 / (2 * 1024 * G),
        "dead_gens_per_call": 0.5})
    # the phases' device time adds up to the strategy's: every kernel but
    # the scan lies in init or a leaf
    phased = got["init_dev_ms_per_call"] / G + sum(
        got[f"{k}_dev_ms_per_gen"] for k in ("ask", "dedup", "commit",
                                             "tell"))
    assert phased == pytest.approx(load("strategy_dev_ms_per_gen").read(r))


def test_the_readers_read_nothing_without_spans_or_counters(monkeypatch):
    monkeypatch.delitem(sys.modules, phases.PROGRAM, raising=False)
    for trace in (None, summary(with_spans=False), summary()):
        r = run_of(trace)
        for name in ("live_run_share", "dead_gens_per_call"):
            assert load(name).read(r) is None
        if trace is None or not any(phases.is_span(n)
                                    for _, _, n in trace._host):
            for name in NEW:
                assert load(name).read(r) is None


def test_no_kernel_is_put_down_where_launches_and_kernels_disagree(program):
    r = run_of(summary(drop_launch=True))
    assert phases.of(r.trace).by_kernel is None
    for name in NEW[:5]:
        assert load(name).read(r) is None
    # the host's spans and the counters still read
    for name in NEW[5:]:
        assert load(name).read(r) is not None


def test_counters_of_other_calls_than_the_traced_ones_read_nothing(program):
    program.calls = 3
    r = run_of(summary())
    assert phases.counters(r) is None
    assert load("live_run_share").read(r) is None
    del program.dead_gens
    program.calls = 2
    assert phases.counters(r) is None

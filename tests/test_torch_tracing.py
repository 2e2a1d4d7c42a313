"""``free_run`` under ``torch.profiler``: its spans, its counters, and
outputs that tracing leaves bit for bit as they are.

While a profiler records, ``repro_torch.core.engine_torch.free_run`` marks
its phases with host spans and adds to the module's counters (``calls``,
``run_gens``, ``live_run_gens``, ``dead_gens``); otherwise it does
neither. The spans are plain host ranges, not user annotations, which the
profiler would mirror on the device beside the kernels. Every call here runs on ``device="cpu"`` over
a small synthetic space whose budget stops runs at different generations
(all of random search's runs stop within a few generations).
"""
import numpy as np
import pytest
from _synth import parity_cache, total_charge
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.cache import CacheFile
from repro_torch.core.engine_torch import strategies as frs

NAMES = sorted(frs.FREE_RUN_STRATEGIES)
SYNTH = parity_cache()
R, G = 8, 30
CASE = {"runs": R, "seed": 4, "generations": G,
        "max_seconds": total_charge(SYNTH) * 0.3}
LEAVES = ("free_run.ask", "free_run.dedup", "free_run.scan",
          "free_run.tell", "free_run.commit")
COUNTERS = ("calls", "run_gens", "live_run_gens", "dead_gens")


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """``parity_cache()`` as the port loads it."""
    path = str(tmp_path_factory.mktemp("tracing") / "parity.json.gz")
    SYNTH.save(path)
    return CacheFile.load(path)


@pytest.fixture
def zeroed(monkeypatch):
    """The module's counters from zero, restored afterwards."""
    for name in COUNTERS:
        monkeypatch.setattr(frs, name, 0)


def counters() -> dict:
    return {name: getattr(frs, name) for name in COUNTERS}


def run(cache, name, **kw):
    return frs.free_run(cache, name, device="cpu", **{**CASE, **kw})


def traced(cache, name, **kw):
    """The call's outputs, its program spans and its other host events,
    each (start, end, name), from a profiler recording it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run(cache, name, **kw)
    spans, ops = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        item = (e.time_range.start, e.time_range.end, e.name)
        if e.name.startswith("free_run"):
            assert not e.is_user_annotation, e.name
            spans.append(item)
        else:
            ops.append(item)
    return out, spans, ops


def inside(a, b) -> bool:
    return b[0] <= a[0] and a[1] <= b[1]


def of(spans, name) -> list:
    return sorted(s for s in spans if s[2] == name)


@pytest.mark.parametrize("name", NAMES)
def test_outputs_are_bit_identical_with_and_without_the_profiler(cache,
                                                                 name):
    plain = run(cache, name)
    got, _, _ = traced(cache, name)
    assert sorted(got) == sorted(plain)
    for k in plain:
        assert got[k].dtype == plain[k].dtype, k
        assert np.array_equal(got[k], plain[k]), k


@pytest.mark.parametrize("name", NAMES)
def test_a_traced_call_has_its_spans_nested_by_phase(cache, name):
    _, spans, ops = traced(cache, name)
    (call,) = of(spans, "free_run")
    (init,) = of(spans, "free_run.init")
    (to_host,) = of(spans, "free_run.to_host")
    gens = of(spans, "free_run.gen")
    assert len(gens) == G
    assert all(inside(s, call) for s in [init, to_host] + gens)
    assert init[1] <= gens[0][0] and gens[-1][1] <= to_host[0]
    leaves = {leaf: of(spans, leaf) for leaf in LEAVES}
    for leaf, found in leaves.items():
        assert len(found) == G, leaf
    for g, gen in enumerate(gens):
        mine = [leaves[leaf][g] for leaf in LEAVES]
        assert all(inside(s, gen) for s in mine)
        # the phases follow each other in the listed order
        assert all(a[1] <= b[0] for a, b in zip(mine, mine[1:]))
    # every operation of a generation runs inside one of its leaves, and
    # every operation of the call inside init, a generation or to_host
    for op in ops:
        if not inside(op, call):
            continue
        assert sum(inside(op, s) for s in [init, to_host] + gens) == 1, op
        if any(inside(op, gen) for gen in gens):
            assert sum(inside(op, s) for found in leaves.values()
                       for s in found) == 1, op


@pytest.mark.parametrize("name", NAMES)
def test_an_untraced_call_leaves_the_counters_unchanged(cache, name,
                                                        zeroed):
    run(cache, name)
    assert counters() == dict.fromkeys(COUNTERS, 0)
    traced(cache, name)
    before = counters()
    run(cache, name)
    assert counters() == before and before["calls"] == 1


@pytest.mark.parametrize("name", NAMES)
def test_the_counters_equal_a_recount(cache, name, zeroed):
    """A pinned seed repeats the same first g generations, so the runs
    live at the start of generation g are those that a call of g
    generations does not report exhausted."""
    traced(cache, name)
    stopped = [0] + [int(run(cache, name, generations=g)["exhausted"].sum())
                     for g in range(1, G)]
    assert counters() == {
        "calls": 1, "run_gens": R * G,
        "live_run_gens": sum(R - s for s in stopped),
        "dead_gens": sum(s == R for s in stopped)}
    assert counters()["live_run_gens"] < R * G
    if name == "random_search":
        assert counters()["dead_gens"] > 0

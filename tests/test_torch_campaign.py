"""The port's fused campaigns against the reference's numpy engine.

``repro_torch.core.engine_torch.campaign`` drives whole tuning runs — ask
-> budget-replay-commit -> tell — with one budget-scan launch a segment of
all of a group's runs, while a host trajectory oracle steps the real
strategy code. Here every runner sits on ``device="cpu"``, so each launch
is a call of the kernel's plain PyTorch version. The committed state is
held against the reference's numpy ``drive_many``
(``repro.core.driver.drive_many``, ``engine="numpy"``) and the port's own
numpy engine; both packages load the same ``_synth.parity_cache`` file.
Tolerance: none — traces, memo keys, budget floats, ``fresh_evals``,
exhaustion points and scores must be bit-identical.

The cases are tests/test_campaign_fused.py's, differential evolution
included. The reference's fused path cannot run
beside them: its jax engine does not import on this jax. On the card,
tests/test_torch_cuda.py holds ``drive_fused`` on ``cuda`` against the
same drivers on the CPU.
"""
import math
import pickle
import random
import sys
import threading
import warnings

import numpy as np
import pytest
import torch
from _compat import given, settings, st
from _synth import parity_cache, total_charge

import repro.core.methodology as ref_meth
from repro.core.budget import Budget as RefBudget
from repro.core.cache import CacheFile as RefCacheFile
from repro.core.driver import SearchDriver as RefDriver
from repro.core.driver import drive_many as ref_drive_many
from repro.core.runner import SimulationRunner as RefRunner
from repro.core.strategies import get_strategy as ref_get_strategy
from repro_torch.core import driver as driver_mod
from repro_torch.core import engine_torch
from repro_torch.core.budget import Budget
from repro_torch.core.cache import CacheFile
from repro_torch.core.driver import FuseFallbackNotice, SearchDriver, drive_many
from repro_torch.core.engine_torch import campaign
from repro_torch.core.engine_torch import replay as rp
from repro_torch.core.methodology import evaluate_strategy, make_scorer
from repro_torch.core.runner import SimulationRunner
from repro_torch.core.strategies import get_strategy

SYNTH = parity_cache()
TOTAL = total_charge(SYNTH)

# tests/test_campaign_fused.py's CASES:
# mid-generation eval exhaustion, mid-batch time exhaustion, and a natural
# finish (random_search is the only fused strategy that stops asking on
# its own)
CASES = [
    ("random_search", {}, {"max_seconds": 1e9}),
    ("random_search", {}, {"max_evals": 37}),
    ("genetic_algorithm",
     {"popsize": 20, "maxiter": 100, "method": "uniform",
      "mutation_chance": 10}, {"max_seconds": TOTAL * 0.4}),
    ("genetic_algorithm",
     {"popsize": 30, "maxiter": 50, "method": "two_point",
      "mutation_chance": 20}, {"max_evals": 137}),
    ("pso", {"popsize": 20, "maxiter": 100, "c1": 2.0, "c2": 1.0},
     {"max_seconds": TOTAL * 0.3}),
    ("pso", {"popsize": 30, "maxiter": 50, "c1": 1.0, "c2": 0.5},
     {"max_seconds": TOTAL * 0.25, "max_evals": 100}),
    ("differential_evolution", {}, {"max_seconds": TOTAL * 0.2}),
]


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """The same cache file, loaded once by each package."""
    path = str(tmp_path_factory.mktemp("campaign") / "parity.json.gz")
    SYNTH.save(path)
    return RefCacheFile.load(path), CacheFile.load(path)


@pytest.fixture(autouse=True)
def _fresh_notice_latch():
    """The fallback notice fires once per (strategy, reason) per process;
    reset so each test observes its own warnings."""
    saved = set(driver_mod._fuse_noticed)
    driver_mod._fuse_noticed.clear()
    yield
    driver_mod._fuse_noticed.clear()
    driver_mod._fuse_noticed.update(saved)


def _observable(r):
    return ([(t, v, tuple(c)) for t, v, c in r.trace], r.fresh_evals,
            r.budget.spent_seconds, r.budget.spent_evals, sorted(r.memo))


def _ref_driver(caches, name, hp, seed, budget_kw):
    runner = RefRunner(caches[0], RefBudget(**budget_kw), engine="numpy")
    return RefDriver(ref_get_strategy(name, **hp), caches[0].space, runner,
                     random.Random(seed))


def _driver(caches, name, hp, seed, budget_kw, engine="torch"):
    runner = SimulationRunner(caches[1], Budget(**budget_kw), engine=engine,
                              device="cpu")
    return SearchDriver(get_strategy(name, **hp), caches[1].space, runner,
                        random.Random(seed))


def _improvements_scan(trace):
    """Sequential reference: strict running-minimum improvements."""
    ts, bs, best = [], [], math.inf
    for t, v, _cfg in trace:
        if v < best:
            best = v
            ts.append(t)
            bs.append(v)
    return np.asarray(ts, dtype=np.float64), np.asarray(bs, dtype=np.float64)


# ----------------------------------------------------------- bit-parity
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drive_many_device_bit_identical(caches, seed):
    """fuse="device" commits the same observable runner state as the
    reference's numpy drive and the port's numpy engine, case by case,
    and records the chosen mode."""
    ref = [_ref_driver(caches, n, hp, seed + i, bk)
           for i, (n, hp, bk) in enumerate(CASES)]
    host = [_driver(caches, n, hp, seed + i, bk, "numpy")
            for i, (n, hp, bk) in enumerate(CASES)]
    dev = [_driver(caches, n, hp, seed + i, bk)
           for i, (n, hp, bk) in enumerate(CASES)]
    ref_drive_many(ref)
    drive_many(host)
    drive_many(dev, fuse="device")
    for (name, _hp, _bk), a, h, b in zip(CASES, ref, host, dev):
        assert b.fuse == "device", name
        assert _observable(a.runner) == _observable(b.runner), name
        assert _observable(h.runner) == _observable(b.runner), name
        assert a.exhausted == b.exhausted == h.exhausted, name


def test_fused_group_matches_isolated_runs(caches):
    """One grouped launch over heterogeneous runs commits the same
    per-run state as driving each run fused on its own."""
    grouped = [_driver(caches, n, hp, 10 + i, bk)
               for i, (n, hp, bk) in enumerate(CASES)]
    engine_torch.drive_fused(grouped)
    for i, (n, hp, bk) in enumerate(CASES):
        alone = _driver(caches, n, hp, 10 + i, bk)
        engine_torch.drive_fused([alone])
        assert _observable(alone.runner) == _observable(grouped[i].runner)


@given(seed=st.integers(0, 2 ** 20),
       name=st.sampled_from(["random_search", "genetic_algorithm", "pso",
                             "differential_evolution"]),
       by_evals=st.booleans(), n_evals=st.integers(1, 150),
       sec_frac=st.floats(0.02, 0.6))
@settings(max_examples=25, deadline=None)
def test_fused_parity_sweep(caches, seed, name, by_evals, n_evals, sec_frac):
    """Random budgets exhaust mid-generation/mid-batch at arbitrary
    points; the committed prefix stays bit-identical throughout."""
    budget_kw = ({"max_evals": n_evals} if by_evals
                 else {"max_seconds": TOTAL * sec_frac})
    a = _ref_driver(caches, name, {}, seed, budget_kw)
    b = _driver(caches, name, {}, seed, budget_kw)
    ref_drive_many([a])
    drive_many([b], fuse="device")
    assert _observable(a.runner) == _observable(b.runner)
    assert a.exhausted == b.exhausted


# ------------------------------------------------------- scores-only path
@pytest.mark.parametrize("seed", [3, 11])
def test_materialize_false_improvements_bit_identical(caches, seed):
    """``drive_fused(materialize=False)`` never builds Observations, yet
    ``FusedRun.improvements()`` reproduces the sequential improvement
    scan of the reference's materialized numpy trace bit for bit."""
    for i, (name, hp, bk) in enumerate(CASES):
        ref = _ref_driver(caches, name, hp, seed + i, bk)
        ref_drive_many([ref])
        dev = _driver(caches, name, hp, seed + i, bk)
        (run,) = engine_torch.drive_fused([dev], materialize=False)
        assert dev.runner.trace == []  # nothing materialized
        ts, bs = run.improvements()
        ref_ts, ref_bs = _improvements_scan(ref.runner.trace)
        assert np.array_equal(ts, ref_ts), name
        assert np.array_equal(bs, ref_bs), name
        assert run.fresh_evals == ref.runner.fresh_evals, name
        assert run.spent == ref.runner.budget.spent_seconds, name


def test_improvements_matches_trace_scan(caches):
    """``improvements()`` == scanning ``trace()`` — including the
    non-finite guard (inf failures never improve)."""
    dev = _driver(caches, "random_search", {}, 5, {"max_seconds": 1e9})
    (run,) = engine_torch.drive_fused([dev], materialize=False)
    trace = run.trace()
    assert any(not math.isfinite(v) for _t, v, _c in trace)  # inf rows hit
    ts, bs = run.improvements()
    ref_ts, ref_bs = _improvements_scan(trace)
    assert np.array_equal(ts, ref_ts)
    assert np.array_equal(bs, ref_bs)


# -------------------------------------------- (hyperparam × seed) grid
@pytest.mark.parametrize("hp,seed", [
    ({"popsize": 10, "maxiter": 8, "method": "uniform",
      "mutation_chance": 10}, 0),
    ({"popsize": 16, "maxiter": 6, "method": "two_point",
      "mutation_chance": 20}, 7),
])
def test_evaluate_strategy_device_grid_parity(caches, hp, seed):
    """The methodology routed through the fused executor: scores
    bit-identical to the reference's evaluate_strategy and to the port's
    sequential drive; "auto" on the torch engine takes the device."""
    def ours(drive):
        return evaluate_strategy(
            lambda: get_strategy("genetic_algorithm", **hp),
            [make_scorer(caches[1], device="cpu")], repeats=4, seed=seed,
            drive=drive)

    ref = ref_meth.evaluate_strategy(
        lambda: ref_get_strategy("genetic_algorithm", **hp),
        [ref_meth.make_scorer(caches[0])], repeats=4, seed=seed)
    dev, auto, seq = ours("device"), ours("auto"), ours("sequential")
    assert (dev.fuse, auto.fuse, seq.fuse) == ("device", "device",
                                               "sequential")
    for rep in (dev, auto, seq):
        assert rep.score == ref.score
        assert np.array_equal(rep.curve, ref.curve)
        assert (rep.fresh_evals, rep.simulated_seconds) == \
            (ref.fresh_evals, ref.simulated_seconds)
        assert rep.per_space_score == ref.per_space_score


# ------------------------------------------------------ suspend / resume
def test_snapshot_after_fused_drive_pickles_and_resumes(caches):
    """Post-fused-drive snapshots carry no device tensors and resume into
    either engine with identical observable state."""
    bk = {"max_seconds": TOTAL * 0.4}
    dev = _driver(caches, "genetic_algorithm",
                  {"popsize": 20, "maxiter": 100, "method": "uniform",
                   "mutation_chance": 10}, 1, bk)
    drive_many([dev], fuse="device")
    payload = pickle.dumps(dev.snapshot())
    for eng in ("numpy", "torch"):
        runner = SimulationRunner(caches[1], Budget(**bk), engine=eng,
                                  device="cpu")
        res = SearchDriver.resume(dev.strategy, caches[1].space, runner,
                                  pickle.loads(payload))
        assert _observable(res.runner) == _observable(dev.runner)


def test_mid_run_resume_finishes_fused(caches):
    """A sequential mid-run snapshot resumes onto the device path and
    finishes bit-identically to the reference finishing on numpy."""
    hp = {"popsize": 20, "maxiter": 100, "method": "uniform",
          "mutation_chance": 10}
    bk = {"max_evals": 137}
    ref = _ref_driver(caches, "genetic_algorithm", hp, 9, bk)
    cut = _driver(caches, "genetic_algorithm", hp, 9, bk, "numpy")
    for _ in range(3):
        assert ref.step() and cut.step()
    snap = pickle.loads(pickle.dumps(cut.snapshot()))
    runner = SimulationRunner(caches[1], Budget(**bk), engine="torch",
                              device="cpu")
    res = SearchDriver.resume(cut.strategy, caches[1].space, runner, snap)
    ref_drive_many([ref])
    drive_many([res], fuse="device")
    assert res.fuse == "device"
    assert _observable(ref.runner) == _observable(res.runner)


# ------------------------------------------------------- fallback protocol
def test_fallback_notice_names_strategy_and_reason(caches):
    """Simulated annealing (not array-native) degrades to the host drive
    with a one-time notice naming the strategy and the reason."""
    ds = [_driver(caches, "simulated_annealing", {}, s, {"max_evals": 40})
          for s in range(2)]
    refs = [_ref_driver(caches, "simulated_annealing", {}, s,
                        {"max_evals": 40}) for s in range(2)]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ref_drive_many(refs)
        drive_many(ds, fuse="device")
    notices = [w for w in caught if issubclass(w.category, FuseFallbackNotice)]
    assert len(notices) == 1  # once per (strategy, reason), not per run
    msg = str(notices[0].message)
    assert "simulated_annealing" in msg and "array-native" in msg
    for d, ref in zip(ds, refs):
        assert d.fuse == "host"
        assert _observable(d.runner) == _observable(ref.runner)


def test_fallback_mode_surfaces_in_report(caches):
    """evaluate_strategy(drive="device") on an ineligible strategy ends up
    on the host drive — and says so on the report."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rep = evaluate_strategy(lambda: get_strategy("simulated_annealing"),
                                [make_scorer(caches[1], device="cpu")],
                                repeats=2, seed=0, drive="device")
    assert rep.fuse == "host"
    assert any(issubclass(w.category, FuseFallbackNotice) for w in caught)
    ref = ref_meth.evaluate_strategy(
        lambda: ref_get_strategy("simulated_annealing"),
        [ref_meth.make_scorer(caches[0])], repeats=2, seed=0)
    assert rep.score == ref.score


def test_eligible_strategies_raise_no_notice(caches):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        drivers = [_driver(caches, n, hp, 4 + i, bk)
                   for i, (n, hp, bk) in enumerate(CASES)]
        drive_many(drivers, fuse="device")
    assert not [w for w in caught
                if issubclass(w.category, FuseFallbackNotice)]
    assert all(d.fuse == "device" for d in drivers)


# ------------------------------------------------------- the port's own
def test_device_drive_without_cuda_raises_and_never_runs(caches):
    """With no device named, the device path means the card: without CUDA
    it raises before any run commits, and never runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    d = SearchDriver(get_strategy("genetic_algorithm"), caches[1].space,
                     SimulationRunner(caches[1], Budget(max_evals=40),
                                      engine="numpy"), random.Random(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        drive_many([d], fuse="device")
    assert (d.runner.fresh_evals, d.runner.trace, d.fuse) == \
        (0, [], "sequential")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_strategy(lambda: get_strategy("random_search"),
                          [make_scorer(caches[1], engine="vectorized")],
                          repeats=1, drive="device")


def test_group_on_two_devices_raises(caches):
    drivers = [_driver(caches, "genetic_algorithm", {}, s,
                       {"max_evals": 40}) for s in range(2)]
    drivers[1].runner.device = "cuda"  # set past resolve_device
    with pytest.raises(ValueError, match="share one device"):
        engine_torch.drive_fused(drivers)
    assert all(d.runner.fresh_evals == 0 for d in drivers)


@pytest.mark.parametrize("runs", [1, 3, 4, 32])
def test_scan_blocks_take_runs(runs):
    """``ScanLayout`` keeps every field 8-byte aligned at R runs, and an
    R-run packed call on the CPU equals ``budget_scan_plain`` on the same
    inputs; a smaller layout after it reuses the grown blocks."""
    npad = 64
    layout = rp.ScanLayout(runs, npad)
    for fields in (rp.IN_FIELDS, rp.OUT_FIELDS):
        assert all(layout.offsets[name] % 8 == 0 for name, _t, _p in fields)
    rng = np.random.default_rng(runs)
    v = 500
    col = np.where(rng.random(v) < 0.2, -1, rng.permutation(v)).astype(
        np.int32)
    tables = rp.ReplayTables.__new__(rp.ReplayTables)
    tables.col_of_row = torch.from_numpy(col)
    tables.time_s = torch.from_numpy(rng.random(v))
    tables.charge_s = torch.from_numpy(rng.random(v))
    inputs = {"rows": rng.integers(0, v, (runs, npad)),
              "fresh": rng.random((runs, npad)) < 0.9,
              "spent0": rng.random(runs), "evals0": rng.integers(0, 3, runs),
              "max_s": np.where(np.arange(runs) % 2, rng.random(runs) * 20,
                                np.inf),
              "max_e": np.full(runs, 2 ** 62, dtype=np.int64)}
    blocks = rp.ScanBlocks("cpu")
    inp, out = blocks.call(npad, runs=runs)
    for name, x in inputs.items():
        inp[name][...] = x
    blocks.run(npad, tables, 0.37, runs=runs)
    want = rp.budget_scan_plain(
        *(torch.from_numpy(np.ascontiguousarray(inputs[k]))
          for k in ("rows", "fresh")), tables.col_of_row, tables.time_s,
        tables.charge_s, 0.37,
        *(torch.from_numpy(np.ascontiguousarray(inputs[k]))
          for k in ("spent0", "evals0", "max_s", "max_e")))
    for name, w in zip(rp.OUT_ORDER, want):
        assert torch.equal(torch.from_numpy(out[name]), w), name
    grown = dict(blocks.nbytes)
    assert grown == layout.nbytes
    blocks.call(8, runs=1)
    assert blocks.nbytes == grown and blocks.capacity == npad


def test_scan_blocks_one_set_per_device_and_thread():
    mine = campaign.scan_blocks("cpu")
    assert campaign.scan_blocks(torch.device("cpu")) is mine
    other = []
    t = threading.Thread(target=lambda: other.append(
        campaign.scan_blocks("cpu")))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and other and other[0] is not mine


def test_fused_group_launches_as_reported(caches, monkeypatch):
    """Each segment of a group is one packed call: as many budget-scan
    calls (the plain version, on the CPU) as ``_drive_group`` reports,
    each at R = the group's padded width."""
    calls = []
    plain = rp.budget_scan_plain

    def counted(rows, *args, **kwargs):
        calls.append(tuple(rows.shape))
        return plain(rows, *args, **kwargs)

    monkeypatch.setattr(rp, "budget_scan_plain", counted)
    runs = [campaign.FusedRun(_driver(caches, n, hp, 20 + i, bk))
            for i, (n, hp, bk) in enumerate(CASES[2:])]
    launches = campaign._drive_group(runs, caches[1].columns,
                                     caches[1].space.compiled)
    assert launches == len(calls) >= 1
    # five runs, padded as the reference pads them (at least 8)
    assert calls[0][0] == rp._pad_len(5) == 8
    assert all(r.done for r in runs)


def test_fused_drives_in_threads_match_serial(caches):
    """Groups driven from eight threads at once (as a
    CampaignExecutor's threads drive them), with a short switch interval:
    each thread's blocks are its own, so every run commits what it
    commits alone."""
    def drive(seed):
        drivers = [_driver(caches, n, {}, seed + i, {"max_evals": 30})
                   for i, n in enumerate(("random_search",
                                          "genetic_algorithm", "pso"))]
        engine_torch.drive_fused(drivers)
        return [_observable(d.runner) for d in drivers]

    seeds = range(8)
    want = [drive(s) for s in seeds]
    got: dict = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-3)
    try:
        threads = [threading.Thread(target=lambda s=s: got.update(
            {s: drive(s)})) for s in seeds]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert [got[s] for s in seeds] == want


@pytest.mark.parametrize("name", ["genetic_algorithm", "pso"])
def test_capped_run_ends_in_the_launch_that_refuses(caches, name):
    """A run whose rows fit one segment is one launch, whatever generation
    its budget runs out in: the oracle extends the segment past the spent
    budget (and past revisit-only asks) up to the fresh row the device
    refuses, so no launch carries a lone trailing generation."""
    for cap in range(5, 60, 3):
        d = _driver(caches, name, {"popsize": 10}, cap, {"max_evals": cap})
        run = campaign.FusedRun(d)
        launches = campaign._drive_group([run], caches[1].columns,
                                         caches[1].space.compiled)
        assert (launches, run.exhausted, run.evals) == (1, True, cap), cap

"""The port's ask/tell protocol against the reference's: the thread bridge,
the legacy ``_optimize`` path and the sequential fallbacks, over all nine
strategies.

Dual annealing wraps ``scipy.optimize.dual_annealing``, which owns its
loop, so it runs either by ``Strategy.run``'s direct dispatch of
``_optimize`` or, under ``SearchDriver``/``drive_many``, on the bridge
thread of ``ThreadBridgeState`` with every evaluation handed to the
driving thread. Both ways, and for every other strategy through its native
or generator path, the runner's trace, memo, budget floats and fresh
evaluations must equal the reference's with ``==`` (same scipy, one
process). Both packages load the same ``_synth.parity_cache`` file; the
torch engine runs on ``device="cpu"`` (the budget scan's plain version).

``FLASH_ATTENTION`` is the flash-attention recording of the card's smoke
run (NVIDIA H100 80GB HBM3, starcoder2-7b width, 5 x 5 x 2 tilings), as
literal (time, charge) pairs: basin hopping stops finding fresh configs
there before its budget is spent and revisits forever, in both packages
(ROADMAP Queue 3), and the test below pins where.
"""
import pickle
import random
import threading
import warnings

import numpy as np
import pytest
from _synth import parity_cache, total_charge

import repro.core.driver as ref_driver
import repro.core.methodology as ref_meth
from repro.core.budget import Budget as RefBudget
from repro.core.budget import BudgetExhausted as RefExhausted
from repro.core.cache import CachedResult as RefResult
from repro.core.cache import CacheFile as RefCacheFile
from repro.core.runner import SimulationRunner as RefRunner
from repro.core.searchspace import SearchSpace as RefSpace
from repro.core.strategies import get_strategy as ref_get_strategy
from repro.core.tunable import tunables_from_dict as ref_tunables
from repro_torch.core import driver as driver_mod
from repro_torch.core import methodology
from repro_torch.core.budget import Budget, BudgetExhausted
from repro_torch.core.cache import CachedResult, CacheFile
from repro_torch.core.driver import (FuseFallbackNotice,
                                     ProtocolDeprecationWarning, SearchDriver,
                                     ThreadBridgeState, drive_many)
from repro_torch.core.runner import SimulationRunner
from repro_torch.core.searchspace import SearchSpace
from repro_torch.core.strategies import STRATEGIES, Strategy, get_strategy
from repro_torch.core.strategies.dual_annealing import METHODS
from repro_torch.core.tunable import tunables_from_dict

SYNTH = parity_cache()
TOTAL = total_charge(SYNTH)
NAMES = sorted(STRATEGIES)
# how evaluate_strategy(drive="auto") drives each on the torch engine
DRIVES = {"random_search": "device", "genetic_algorithm": "device",
          "pso": "device", "differential_evolution": "device",
          "simulated_annealing": "host", "basin_hopping": "host",
          "greedy_ils": "host", "mls": "host",
          "dual_annealing": "sequential"}

FLASH_TUNABLES = {"block_q": (64, 128, 256, 512, 1024),
                  "block_kv": (128, 256, 512, 1024, 2048),
                  "acc_dtype": ("f32", "bf16")}
FLASH_ATTENTION = {  # config: (time_s, charge_s)
    (64, 128, 'f32'): (0.004788096000003368, 0.019287233000014226),
    (64, 128, 'bf16'): (0.004782372000003458, 0.019186391000005187),
    (64, 256, 'f32'): (0.004937208666665545, 0.019866559000007555),
    (64, 256, 'bf16'): (0.005016594666670926, 0.020113350000016794),
    (64, 512, 'f32'): (0.0052572006666669795, 0.021129845000004366),
    (64, 512, 'bf16'): (0.005267842000004445, 0.021192701000003922),
    (64, 1024, 'f32'): (0.00590677800000113, 0.023672666999999592),
    (64, 1024, 'bf16'): (0.005818153666666603, 0.023370095999993623),
    (64, 2048, 'f32'): (0.007187663999999927, 0.028981247999993798),
    (64, 2048, 'bf16'): (0.0072757243333304205, 0.029299217999991356),
    (128, 128, 'f32'): (0.004281277333338569, 0.017201808000024243),
    (128, 128, 'bf16'): (0.004233592000000878, 0.01697888299999306),
    (128, 256, 'f32'): (0.0044417706666640315, 0.01780884699999774),
    (128, 256, 'bf16'): (0.0043876803333281105, 0.017613519999983396),
    (128, 512, 'f32'): (0.004728199333333312, 0.018938427999998453),
    (128, 512, 'bf16'): (0.004666198999998983, 0.018762226000006876),
    (128, 1024, 'f32'): (0.0051591790000079145, 0.020697992000023646),
    (128, 1024, 'bf16'): (0.005116482999994787, 0.02055191599998807),
    (128, 2048, 'f32'): (0.006598254666660826, 0.026499055999977372),
    (128, 2048, 'bf16'): (0.006494166666665062, 0.026029735999998138),
    (256, 128, 'f32'): (0.0044124720000032385, 0.017730225000022415),
    (256, 128, 'bf16'): (0.004419583666665024, 0.017771641999999588),
    (256, 256, 'f32'): (0.004430464999998662, 0.01780935499999714),
    (256, 256, 'bf16'): (0.004518678000001349, 0.01813754399999823),
    (256, 512, 'f32'): (0.004674981999997385, 0.018756647999992992),
    (256, 512, 'bf16'): (0.004677088999997636, 0.01877717299998949),
    (256, 1024, 'f32'): (0.005136983999998772, 0.020639723000002164),
    (256, 1024, 'bf16'): (0.005191067666662737, 0.02082266199998628),
    (256, 2048, 'f32'): (0.006535003333330754, 0.026278342999987103),
    (256, 2048, 'bf16'): (0.006520593666664354, 0.026170681999985845),
    (512, 128, 'f32'): (0.00474848066666785, 0.019071581999995146),
    (512, 128, 'bf16'): (0.004738474333332003, 0.019006970999996042),
    (512, 256, 'f32'): (0.004656362333335551, 0.01875862400001438),
    (512, 256, 'bf16'): (0.004747084000001678, 0.019061445000005506),
    (512, 512, 'f32'): (0.004696530999998079, 0.01882363599999337),
    (512, 512, 'bf16'): (0.004681796333334394, 0.018821492000000717),
    (512, 1024, 'f32'): (0.005660022999999607, 0.022654428999999254),
    (512, 1024, 'bf16'): (0.005564499666666241, 0.022341015999998604),
    (512, 2048, 'f32'): (0.007404696666663805, 0.029733893999988936),
    (512, 2048, 'bf16'): (0.007477210666664291, 0.02996360399998821),
    (1024, 128, 'f32'): (0.007432100333337151, 0.029801300000016795),
    (1024, 128, 'bf16'): (0.007438633333331761, 0.029803700999991634),
    (1024, 256, 'f32'): (0.007461030333336301, 0.029879265000005262),
    (1024, 256, 'bf16'): (0.007356067999997625, 0.029543183999990674),
    (1024, 512, 'f32'): (0.0073805336666670955, 0.029660763999999062),
    (1024, 512, 'bf16'): (0.0073680756666713405, 0.02955896000001701),
    (1024, 1024, 'f32'): (0.00735170500000019, 0.029503848000004496),
    (1024, 1024, 'bf16'): (0.007390534333325149, 0.02964797599997837),
    (1024, 2048, 'f32'): (0.007479706333332577, 0.03003493599999274),
    (1024, 2048, 'bf16'): (0.007462806333331666, 0.02993951400000583),
}


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """The same cache file, loaded once by each package."""
    path = str(tmp_path_factory.mktemp("protocol") / "parity.json.gz")
    SYNTH.save(path)
    return RefCacheFile.load(path), CacheFile.load(path)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A 48-config recording on which every strategy's runs end at the
    methodology's budget (basin hopping's do not on ``SYNTH``)."""
    path = str(tmp_path_factory.mktemp("protocol") / "small.json")
    parity_cache(n_a=8, n_b=3, name="small", fail_every=7).save(path)
    return RefCacheFile.load(path), CacheFile.load(path)


@pytest.fixture(autouse=True)
def _fresh_notice_latch():
    """The fallback notice fires once per (strategy, reason) per process;
    reset so each test observes its own notices."""
    saved = set(driver_mod._fuse_noticed)
    driver_mod._fuse_noticed.clear()
    yield
    driver_mod._fuse_noticed.clear()
    driver_mod._fuse_noticed.update(saved)


def _observable(r):
    return ([(t, v, tuple(c)) for t, v, c in r.trace], r.fresh_evals,
            r.budget.spent_seconds, r.budget.spent_evals, sorted(r.memo))


def _runner(caches, engine="torch", **budget_kw):
    return SimulationRunner(caches[1], Budget(**budget_kw), engine=engine,
                            device="cpu")


def _ref_runner(caches, **budget_kw):
    return RefRunner(caches[0], RefBudget(**budget_kw), engine="numpy")


def _bridge_threads() -> int:
    return sum(t.name == "repro-bridge" and t.is_alive()
               for t in threading.enumerate())


class _LegacyOnly(Strategy):
    """An out-of-tree strategy that still speaks only ``_optimize``."""

    name = "legacy_only"

    def _optimize(self, space, runner, rng):
        while True:
            runner.run(space.random_config(rng))


# ------------------------------------------------------------------ parity
@pytest.mark.parametrize("budget_kw", [{"max_evals": 48},
                                       {"max_seconds": TOTAL * 0.08}],
                         ids=["evals", "seconds"])
@pytest.mark.parametrize("name", NAMES)
def test_strategy_run_equals_reference(caches, name, budget_kw):
    """``Strategy.run`` on the torch engine: the reference's run, bit for
    bit (dual annealing by direct dispatch, the rest through the driver)."""
    ours, ref = _runner(caches, **budget_kw), _ref_runner(caches, **budget_kw)
    best = get_strategy(name).run(caches[1].space, ours, random.Random(5))
    ref_best = ref_get_strategy(name).run(caches[0].space, ref,
                                          random.Random(5))
    assert _observable(ours) == _observable(ref)
    assert (best is None) == (ref_best is None)
    assert best is None or (best.config, best.value) == \
        (ref_best.config, ref_best.value)


@pytest.mark.parametrize("method", METHODS)
def test_dual_annealing_bridge_equals_direct_dispatch(caches, method):
    """Each local method: the bridge under ``SearchDriver`` and the direct
    dispatch in ``Strategy.run`` commit what the reference commits."""
    budget = {"max_seconds": TOTAL * 0.05}
    direct, bridged = _runner(caches, **budget), _runner(caches, **budget)
    ref = _ref_runner(caches, **budget)
    get_strategy("dual_annealing", method=method).run(
        caches[1].space, direct, random.Random(3))
    d = SearchDriver(get_strategy("dual_annealing", method=method),
                     caches[1].space, bridged, random.Random(3))
    assert isinstance(d.state, ThreadBridgeState)
    d.run()
    ref_get_strategy("dual_annealing", method=method).run(
        caches[0].space, ref, random.Random(3))
    assert d.exhausted
    assert _observable(direct) == _observable(bridged) == _observable(ref)
    assert _bridge_threads() == 0


@pytest.mark.parametrize("path", ["run", "driver"])
def test_legacy_optimize_warns_with_the_ports_warning(caches, path):
    """A legacy-only subclass warns with the port's
    ``ProtocolDeprecationWarning`` (never the reference's, which pytest.ini
    escalates) and commits what the bare loop commits."""
    assert ProtocolDeprecationWarning is not \
        ref_driver.ProtocolDeprecationWarning
    runner = _runner(caches, max_evals=25)
    with pytest.warns(ProtocolDeprecationWarning) as caught:
        if path == "run":
            best = _LegacyOnly().run(caches[1].space, runner,
                                     random.Random(3))
        else:
            d = SearchDriver(_LegacyOnly(), caches[1].space, runner,
                             random.Random(3))
            best = d.run()
            assert d.exhausted
    assert not [w for w in caught if issubclass(
        w.category, ref_driver.ProtocolDeprecationWarning)]
    bare = _runner(caches, max_evals=25)
    rng = random.Random(3)
    with pytest.raises(BudgetExhausted):
        while True:
            bare.run(caches[1].space.random_config(rng))
    assert _observable(runner) == _observable(bare)
    assert best == bare.best
    assert _bridge_threads() == 0


def test_dual_annealing_state_is_the_ports_thread_bridge(caches):
    state = get_strategy("dual_annealing").init_state(caches[1].space,
                                                      random.Random(0))
    assert type(state) is ThreadBridgeState
    assert type(state).__module__ == "repro_torch.core.driver"
    state.close()


# --------------------------------------------------------- suspend / resume
@pytest.mark.parametrize("name", NAMES)
def test_state_pickle_roundtrip_mid_run(caches, name):
    """A snapshot pickled mid-run resumes on a fresh runner and finishes
    as the run left alone does, and as the reference's run; the replay
    bridges (generator frames, the scipy thread) rebuild from their logs."""
    budget = {"max_evals": 48}
    alone = _runner(caches, **budget)
    get_strategy(name).run(caches[1].space, alone, random.Random(9))
    ref = _ref_runner(caches, **budget)
    ref_get_strategy(name).run(caches[0].space, ref, random.Random(9))

    part = _runner(caches, **budget)
    d = SearchDriver(get_strategy(name), caches[1].space, part,
                     random.Random(9))
    payload = pickle.dumps(d.snapshot())  # random search: one generation
    for _ in range(3):
        if not d.step():
            break
        payload = pickle.dumps(d.snapshot())
    d.state.close()
    fresh = _runner(caches, **budget)
    resumed = SearchDriver.resume(get_strategy(name), caches[1].space, fresh,
                                  pickle.loads(payload))
    resumed.run()
    assert _observable(fresh) == _observable(alone) == _observable(ref)
    assert _bridge_threads() == 0


# --------------------------------------------------------------- drive_many
def test_drive_many_mixed_strategies_and_exhaustion(caches):
    """GA (native), SA (generator), dual annealing (thread bridge) and
    random search interleaved over one cache, budgets running out at
    different rounds: each run as it commits alone, and as the
    reference's ``drive_many`` commits it."""
    mix = ["genetic_algorithm", "simulated_annealing", "dual_annealing",
           "random_search"]
    budgets = [TOTAL * 0.02, TOTAL * 0.05, TOTAL * 0.03, TOTAL * 0.01]
    alone = []
    for name, b in zip(mix, budgets):
        r = _runner(caches, max_seconds=b)
        get_strategy(name).run(caches[1].space, r, random.Random(7))
        alone.append(r)
    drivers = [SearchDriver(get_strategy(name), caches[1].space,
                            _runner(caches, max_seconds=b), random.Random(7))
               for name, b in zip(mix, budgets)]
    refs = [ref_driver.SearchDriver(ref_get_strategy(name), caches[0].space,
                                    _ref_runner(caches, max_seconds=b),
                                    random.Random(7))
            for name, b in zip(mix, budgets)]
    drive_many(drivers)
    ref_driver.drive_many(refs)
    for d, a, ref in zip(drivers, alone, refs):
        assert _observable(d.runner) == _observable(a) == \
            _observable(ref.runner)
        assert d.state.finished and d.fuse == "host"
    assert _bridge_threads() == 0


@pytest.mark.parametrize("how", ["run", "drive_many", "closed_mid_run",
                                 "evaluate_strategy", "meta_hypertune"])
def test_no_bridge_thread_left_after_a_drive(caches, how):
    """Every way of driving dual annealing joins its bridge thread: the
    process has as many threads after the drive as before it."""
    before = threading.active_count()
    space = caches[1].space
    if how == "run":
        SearchDriver(get_strategy("dual_annealing"), space,
                     _runner(caches, max_evals=30), random.Random(1)).run()
    elif how == "drive_many":
        drive_many([SearchDriver(get_strategy("dual_annealing"), space,
                                 _runner(caches, max_evals=20 + i),
                                 random.Random(i)) for i in range(3)])
    elif how == "closed_mid_run":
        d = SearchDriver(get_strategy("dual_annealing"), space,
                         _runner(caches, max_evals=30), random.Random(1))
        for _ in range(5):
            assert d.step()
        assert _bridge_threads() == 1
        d.state.close()
    elif how == "evaluate_strategy":
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FuseFallbackNotice)
            methodology.evaluate_strategy(
                lambda: get_strategy("dual_annealing"),
                [methodology.make_scorer(caches[1], device="cpu")],
                repeats=2, seed=0)
    else:
        from repro_torch.core.hypertuner import meta_hypertune
        meta_hypertune("greedy_ils", "dual_annealing",
                       [methodology.make_scorer(caches[1], device="cpu")],
                       max_hp_evals=3, repeats=1, seed=0)
    assert _bridge_threads() == 0
    assert threading.active_count() == before


@pytest.mark.parametrize("updating", ["immediate", "deferred"])
@pytest.mark.parametrize("seed", [0, 4])
def test_de_device_fused_equals_numpy_drive(caches, updating, seed):
    """Differential evolution through ``drive_many(fuse="device")`` on the
    CPU (the budget scan's plain version, R runs a launch) commits what
    the reference's numpy ``drive_many`` and the port's numpy engine
    commit, whether the budget stops it by time or by count."""
    budgets = [{"max_seconds": TOTAL * 0.2}, {"max_evals": 57},
               {"max_seconds": TOTAL * 0.07, "max_evals": 90}]
    hp = {"updating": updating, "popsize": 10}

    def ours(engine):
        return [SearchDriver(get_strategy("differential_evolution", **hp),
                             caches[1].space, _runner(caches, engine, **b),
                             random.Random(seed + i))
                for i, b in enumerate(budgets)]

    dev, host = ours("torch"), ours("numpy")
    refs = [ref_driver.SearchDriver(
        ref_get_strategy("differential_evolution", **hp), caches[0].space,
        _ref_runner(caches, **b), random.Random(seed + i))
        for i, b in enumerate(budgets)]
    with warnings.catch_warnings():
        warnings.simplefilter("error", FuseFallbackNotice)
        drive_many(dev, fuse="device")
    drive_many(host)
    ref_driver.drive_many(refs)
    for d, h, ref in zip(dev, host, refs):
        assert d.fuse == "device"
        assert _observable(d.runner) == _observable(h.runner) == \
            _observable(ref.runner)
        assert d.exhausted == h.exhausted == ref.exhausted


# ---------------------------------------------------- sequential fallbacks
def _duck_typed(exhausted):
    """A strategy that exposes only ``run(space, runner, rng)``: random
    draws until its package's ``BudgetExhausted``."""
    class DuckTyped:
        name = "duck_typed_random"

        def run(self, space, runner, rng):
            try:
                while True:
                    runner.run(space.random_config(rng))
            except exhausted:
                return runner.best

    return DuckTyped


@pytest.mark.parametrize("name", NAMES + ["duck_typed"])
def test_evaluate_strategy_auto_drive_modes(small, name):
    """``evaluate_strategy(drive="auto")`` on a torch-engine scorer: the
    array-native strategies run device-fused, the generators on the host
    drive, and dual annealing and a duck-typed strategy sequentially, each
    of the last two after one notice naming the sequential fallback. Every
    score equals the reference's."""
    if name == "duck_typed":
        make, ref_make, want = (_duck_typed(BudgetExhausted),
                                _duck_typed(RefExhausted), "sequential")
    else:
        def make():
            return get_strategy(name)

        def ref_make():
            return ref_get_strategy(name)
        want = DRIVES[name]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rep = methodology.evaluate_strategy(
            make, [methodology.make_scorer(small[1], device="cpu")],
            repeats=3, seed=2)
    ref = ref_meth.evaluate_strategy(ref_make,
                                     [ref_meth.make_scorer(small[0])],
                                     repeats=3, seed=2)
    assert rep.fuse == want
    notices = [str(w.message) for w in caught
               if issubclass(w.category, FuseFallbackNotice)]
    assert len([m for m in notices if "sequential" in m]) == \
        (want == "sequential")
    assert len(notices) == (want != "device") + (want == "sequential")
    assert rep.score == ref.score
    assert np.array_equal(rep.curve, ref.curve)
    assert (rep.fresh_evals, rep.simulated_seconds) == \
        (ref.fresh_evals, ref.simulated_seconds)


# ------------------------------------------------------------ the BH stall
def _flash_caches():
    ours = SearchSpace(tunables_from_dict(FLASH_TUNABLES), name="flash")
    ref = RefSpace(ref_tunables(FLASH_TUNABLES), name="flash")
    assert ours.valid_configs == ref.valid_configs == list(FLASH_ATTENTION)

    def results(space, result):
        return {space.config_id(c): result("ok", t, (), charge, 0.0)
                for c, (t, charge) in FLASH_ATTENTION.items()}

    return (RefCacheFile("flash", "h100", ref, results(ref, RefResult)),
            CacheFile("flash", "h100", ours, results(ours, CachedResult)))


@pytest.mark.parametrize("repeat", [0, 1, 2])
def test_basin_hopping_stalls_where_the_reference_stalls(repeat):
    """On the flash-attention recording basin hopping runs out of fresh
    configs before its budget is spent (fewer than 50 fresh of 50), then
    only revisits, so the run never ends: both packages, driven step by
    step with the same cap, stand in the same state at the cap."""
    ref_cache, cache = _flash_caches()
    scorer = methodology.make_scorer(cache, engine="vectorized")
    ref_scorer = ref_meth.make_scorer(ref_cache)
    assert scorer.budget_s == ref_scorer.budget_s
    cap = 4000
    ours = SimulationRunner(cache, Budget(max_seconds=scorer.budget_s),
                            engine="torch", device="cpu")
    ref = RefRunner(ref_cache, RefBudget(max_seconds=ref_scorer.budget_s),
                    engine="numpy")
    d = SearchDriver(get_strategy("basin_hopping"), cache.space, ours,
                     methodology._repeat_rng(scorer, repeat, 0))
    rd = ref_driver.SearchDriver(ref_get_strategy("basin_hopping"),
                                 ref_cache.space, ref,
                                 ref_meth._repeat_rng(ref_scorer, repeat, 0))
    for _ in range(cap):
        assert d.step() and rd.step()
    assert _observable(ours) == _observable(ref)
    assert ours.fresh_evals < len(FLASH_ATTENTION)
    assert ours.budget.spent_seconds < scorer.budget_s
    fresh = ours.fresh_evals
    for _ in range(cap):
        assert d.step()
    assert ours.fresh_evals == fresh  # only revisits since
    d.state.close()
    rd.state.close()


# ------------------------------------------------ plain configs on the scan
@pytest.mark.parametrize("path", ["direct", "bridge"])
def test_dual_annealing_commits_through_the_budget_scan(caches, path,
                                                       monkeypatch):
    """Dual annealing asks value tuples, one ``runner(cfg)`` at a time: on
    the torch engine each fresh one is a budget-scan call (the plain
    version on the CPU), by direct dispatch and through the bridge, and
    the runner ends as the numpy engine's does."""
    from repro_torch.core.engine_torch import replay as rp
    calls = []
    plain = rp.budget_scan_plain

    def counted(rows, *args, **kwargs):
        calls.append(tuple(rows.shape))
        return plain(rows, *args, **kwargs)

    monkeypatch.setattr(rp, "budget_scan_plain", counted)
    runners = {e: _runner(caches, e, max_seconds=TOTAL * 0.03)
               for e in ("torch", "numpy")}
    for engine, runner in runners.items():
        strategy = get_strategy("dual_annealing")
        if path == "direct":
            strategy.run(caches[1].space, runner, random.Random(4))
        else:
            SearchDriver(strategy, caches[1].space, runner,
                         random.Random(4)).run()
    assert _observable(runners["torch"]) == _observable(runners["numpy"])
    assert len(calls) == runners["torch"].fresh_evals + 1  # + the refused
    assert all(shape[0] == 1 for shape in calls)


def test_plain_config_batches_on_the_torch_engine(caches):
    """``run``/``run_batch`` of plain configs on the torch engine, with
    revisits and a config outside the space's valid set (committed on the
    host, having no row): the numpy engine's state, call by call."""
    space = caches[1].space
    rng = random.Random(8)
    valid = space.compiled.configs
    batches = [[valid[rng.randrange(len(valid))] for _ in range(n)]
               for n in (1, 5, 1, 40, 3)]
    batches[2] = batches[1][:1]  # a revisit
    batches[4].append((999, 0, "p"))  # no row in the space
    runners = {e: _runner(caches, e, max_seconds=TOTAL)
               for e in ("torch", "numpy")}
    for engine, runner in runners.items():
        for batch in batches:
            if len(batch) == 1:
                runner.run(batch[0])
            else:
                runner.run_batch(batch)
    assert _observable(runners["torch"]) == _observable(runners["numpy"])
    assert runners["torch"].torch_engine().dispatches >= 3

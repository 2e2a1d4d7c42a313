"""The port's strategies against the reference's.

Every strategy but random search and the GA is held here (those two are
held by tests/test_torch_hypertuner.py): simulated annealing, PSO, dual
annealing, differential evolution, basin hopping, greedy ILS and MLS. Each
is a copy of the reference's module, so with the same recordings, seeds and
hyperparameters they must draw the same configs and score the same
floats: every comparison here is ``==``, not approximate. The recordings
are the closed-form synthetic caches of tests/_synth.py (written once and
loaded by each package); on all of them the methodology's budget runs out
before a run could have visited every config, so no tuning run can restart
forever (ROADMAP Queue 3).

Basin hopping is scored on a third, 48-config recording: on the two
others most of its runs stop finding fresh configs before the budget is
spent and then revisit forever, in both packages (ROADMAP Queue 3; the
stall itself is pinned by tests/test_torch_protocol.py).
"""
import contextlib
import io

import numpy as np
import pytest
from _synth import parity_cache

import repro.core.hypertuner as ref_ht
import repro.core.methodology as ref_meth
from repro.core.cache import CacheFile as RefCacheFile
from repro.core.parallel import StrategyFactory as RefFactory
from repro.core.strategies import STRATEGIES as REF_STRATEGIES
from repro_torch import cli
from repro_torch.core import hypertuner as ht
from repro_torch.core import methodology
from repro_torch.core.cache import CacheFile
from repro_torch.core.parallel import StrategyFactory
from repro_torch.core.strategies import STRATEGIES, get_strategy

NEW = ("simulated_annealing", "pso", "dual_annealing",
       "differential_evolution", "basin_hopping", "greedy_ils", "mls")
HYPERPARAMS = {  # a non-default point of each Table III grid
    "simulated_annealing": {"T": 0.5, "T_min": 0.01, "alpha": 0.9925,
                            "maxiter": 3},
    "pso": {"popsize": 10, "maxiter": 50, "c1": 3.0, "c2": 0.5},
    "dual_annealing": {"method": "Nelder-Mead"},
    "differential_evolution": {"popsize": 10, "maxiter": 50, "F": 0.4,
                               "CR": 0.5},
    "basin_hopping": {"T": 0.5, "stepsize": 4, "local_iters": 16},
    "greedy_ils": {"perturbation": 4, "restart_chance": 0.2},
    "mls": {"adjacent_only": False},
}
GRID_SIZES = {"simulated_annealing": 81, "pso": 81, "dual_annealing": 8,
              "differential_evolution": 81, "basin_hopping": 27,
              "greedy_ils": 9, "mls": 2}
# how evaluate_strategy(drive="auto") drives each on the torch engine
DRIVES = {"simulated_annealing": "host", "pso": "device",
          "dual_annealing": "sequential", "differential_evolution": "device",
          "basin_hopping": "host", "greedy_ils": "host", "mls": "host"}


@pytest.fixture(scope="module")
def cache_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("strategies")
    paths = [str(d / "parity.json.gz"), str(d / "second.json"),
             str(d / "small.json")]
    parity_cache().save(paths[0])
    parity_cache(n_a=16, n_b=3, name="second", fail_every=7).save(paths[1])
    parity_cache(n_a=8, n_b=3, name="small", fail_every=7).save(paths[2])
    return paths


def _spaces(paths, name):
    """The recordings ``name`` is scored on (see the module docstring)."""
    return paths[2:] if name == "basin_hopping" else paths[:2]


def _ours(paths, engine):
    scorers = [methodology.make_scorer(CacheFile.load(p), engine=engine,
                                       device="cpu") for p in paths]
    for s in scorers:
        charges = s.cache.columns.charge_s
        assert s.budget_s < float(charges.sum()) - float(charges.max()), \
            f"{s.name}: a tuning run could restart forever"
    return scorers


def _ref(paths):
    return [ref_meth.make_scorer(RefCacheFile.load(p)) for p in paths]


def _same_report(a, b):
    assert a.score == b.score
    assert np.array_equal(a.curve, b.curve)
    assert a.per_space_score == b.per_space_score
    assert (a.fresh_evals, a.simulated_seconds) == \
        (b.fresh_evals, b.simulated_seconds)


@pytest.mark.parametrize("name", NEW)
def test_registered_with_the_reference_grids(name):
    cls, ref = STRATEGIES[name], REF_STRATEGIES[name]
    assert cls.name == ref.name == name
    assert cls.__module__.startswith("repro_torch.")
    assert cls.DEFAULTS == ref.DEFAULTS
    assert cls.HYPERPARAM_SPACE == ref.HYPERPARAM_SPACE
    assert cls.EXTENDED_SPACE == ref.EXTENDED_SPACE
    assert type(get_strategy(name, **HYPERPARAMS[name])) is cls


@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("name", NEW)
def test_hyperparam_searchspace_equals_reference(name, extended):
    ours = ht.hyperparam_searchspace(name, extended=extended)
    ref = ref_ht.hyperparam_searchspace(name, extended=extended)
    assert ours.name == ref.name
    assert ours.size == ref.size
    assert extended or ours.size == GRID_SIZES[name]
    assert ours.valid_configs == ref.valid_configs
    assert [ours.config_id(c) for c in ours.valid_configs] == \
        [ref.config_id(c) for c in ref.valid_configs]


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("hp", ["defaults", "table3"])
@pytest.mark.parametrize("name", NEW)
def test_evaluate_strategy_equals_reference(cache_paths, name, hp, seed):
    hyperparams = {} if hp == "defaults" else HYPERPARAMS[name]
    ours = methodology.evaluate_strategy(
        StrategyFactory.create(name, hyperparams),
        _ours(_spaces(cache_paths, name), "vectorized"), repeats=5,
        seed=seed)
    ref = ref_meth.evaluate_strategy(RefFactory.create(name, hyperparams),
                                     _ref(_spaces(cache_paths, name)),
                                     repeats=5, seed=seed)
    _same_report(ours, ref)


@pytest.mark.parametrize("name", NEW)
def test_torch_engine_equals_numpy_engine(cache_paths, name):
    """The torch engine on the CPU commits every fresh batch through the
    budget scan's plain version: the same floats as the numpy engine."""
    for hyperparams in ({}, HYPERPARAMS[name]):
        reports = [methodology.evaluate_strategy(
            StrategyFactory.create(name, hyperparams),
            _ours(_spaces(cache_paths, name), engine), repeats=3, seed=1)
            for engine in ("torch", "vectorized")]
        _same_report(*reports)
        assert reports[0].fuse == DRIVES[name]


@pytest.mark.parametrize("name", NEW)
def test_exhaustive_hypertune_equals_reference(cache_paths, name):
    """The whole Table III grid over the strategy's recordings."""
    spaces = _spaces(cache_paths, name)
    ours = ht.exhaustive_hypertune(name, _ours(spaces, "vectorized"),
                                   repeats=2)
    ref = ref_ht.exhaustive_hypertune(name, _ref(spaces), repeats=2)
    assert list(ours.results) == list(ref.results)
    assert len(ours.results) == GRID_SIZES[name]
    for hp_id, r in ref.results.items():
        assert ours.results[hp_id].hyperparams == r.hyperparams
        _same_report(ours.results[hp_id].report, r.report)
    assert ours.best.hyperparams == ref.best.hyperparams
    assert ours.closest_to_mean().hyperparams == \
        ref.closest_to_mean().hyperparams


@pytest.mark.parametrize("name,meta", [("simulated_annealing", "pso"),
                                       ("pso", "simulated_annealing"),
                                       ("genetic_algorithm",
                                        "simulated_annealing"),
                                       ("genetic_algorithm",
                                        "dual_annealing"),
                                       ("dual_annealing", "pso")])
def test_meta_hypertune_equals_reference(cache_paths, name, meta):
    """Each strategy tunes, or is tuned, as in the reference; dual
    annealing as the meta-strategy runs through the thread bridge."""
    kw = dict(extended=False, max_hp_evals=5, repeats=2, seed=2)
    ours = ht.meta_hypertune(name, meta, _ours(cache_paths[:2], "torch"),
                             **kw)
    ref = ref_ht.meta_hypertune(name, meta, _ref(cache_paths[:2]), **kw)
    assert ours.best_hyperparams == ref.best_hyperparams
    assert ours.best_score == ref.best_score
    assert ours.evaluated == ref.evaluated and len(ours.evaluated) == 5
    assert [t[:2] for t in ours.trace] == [t[:2] for t in ref.trace]


def test_cli_hypertune_and_meta_take_the_new_strategies(cache_paths):
    def run(*argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(list(argv)) == 0
        return buf.getvalue()

    out = run("hypertune", "--strategy", "simulated_annealing", "--cache",
              cache_paths[1], "--repeats", "1", "--engine", "vectorized",
              "--quiet", "--top", "2")
    assert "campaign: 81 configs" in out
    out = run("meta", "--strategy", "pso", "--meta-strategy",
              "simulated_annealing", "--table3-grid", "--max-hp-evals", "3",
              "--cache", cache_paths[1], "--repeats", "1", "--device", "cpu",
              "--quiet")
    assert "(found by simulated_annealing)" in out
    assert "after 3 of 81 grid points" in out
    out = run("meta", "--strategy", "genetic_algorithm", "--meta-strategy",
              "dual_annealing", "--table3-grid", "--max-hp-evals", "3",
              "--cache", cache_paths[1], "--repeats", "1", "--device", "cpu",
              "--quiet")
    assert "(found by dual_annealing)" in out
    assert "after 3 of 108 grid points" in out
    out = run("simulate", "--strategy", "mls", "--cache", cache_paths[1],
              "--repeats", "2", "--device", "cpu")
    assert "[mls x2 repeats, 1 spaces, engine torch on cpu]" in out
    assert "drive: host" in out
    for command in ("record", "simulate", "hypertune", "meta"):
        with pytest.raises(SystemExit), \
                contextlib.redirect_stdout(io.StringIO()) as buf:
            cli.main([command, "--help"])
        for name in NEW:
            assert name in buf.getvalue(), (command, name)

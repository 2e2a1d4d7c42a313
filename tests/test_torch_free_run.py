"""The port's free-running strategies against the reference and numpy.

``repro_torch.core.engine_torch.free_run`` steps R runs of the GA, PSO,
DE or random search through G generations, one budget-scan call a
generation. Here every call runs on ``device="cpu"``, so each generation
calls the kernel's plain PyTorch version. The contract is the
reference's (``src/repro/core/engine_jax/strategies.py``): pinned seeds
reproduce bit for bit; the budget side is exact (eval counts, spend,
exhaustion); best values are only statistically equivalent to the numpy
strategies and to the reference's ``free_run`` (no device stream replays
another's). Tolerances: none on counts, pinned-seed outputs and the best
value of an exhausted space; rtol 1e-10 on an exhausted space's spend
(the permutation orders the float64 sums); means of best values within
3x the spread of the other side's runs, as tests/test_engine_jax.py
holds them.

The reference's ``free_run`` imports ``jax.experimental.enable_x64``,
which this jax no longer has under that name (it is ``jax.enable_x64``).
The ``ref`` fixture therefore runs the reference in a subprocess that
sets ``jax.experimental.enable_x64 = jax.enable_x64`` before importing
it; setting it in this process would let other tests in the same worker
import the reference's jax engine and change what they run.
"""
import json
import os
import random
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from _synth import parity_cache, total_charge

from repro.core.budget import Budget as RefBudget
from repro.core.runner import SimulationRunner as RefRunner
from repro.core.strategies import get_strategy as ref_get_strategy
from repro_torch.core import engine_torch
from repro_torch.core.cache import CachedResult, CacheFile
from repro_torch.core.engine_torch import strategies as frs
from repro_torch.core.engine_torch.tables import replay_tables, space_tables
from repro_torch.kernels import hotspot as hs

REPO = Path(__file__).resolve().parents[1]
SYNTH = parity_cache()
TOTAL = total_charge(SYNTH)
NAMES = sorted(frs.FREE_RUN_STRATEGIES)
# the reference's tests/test_engine_jax.py cases
EVAL_CASE = {"runs": 6, "seed": 1, "generations": 10, "max_evals": 40}
STAT_CASE = {"runs": 24, "seed": 11, "generations": 40,
             "max_seconds": TOTAL * 0.25}
EXHAUST_P = 20
REF_TIMEOUT_S = 600

_REF_SCRIPT = textwrap.dedent("""
    import json, sys
    import jax, jax.experimental
    jax.experimental.enable_x64 = jax.enable_x64  # the import the reference needs
    import numpy as np
    from _synth import parity_cache
    import repro.core.engine_jax as ej
    spec = json.loads(sys.argv[1])
    cache = parity_cache()
    out = {}
    for key, (name, kw) in spec.items():
        for field, arr in ej.free_run(cache, name, **kw).items():
            out[f"{key}/{field}"] = arr
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """``parity_cache()`` as the port loads it (the reference's file)."""
    path = str(tmp_path_factory.mktemp("free_run") / "parity.json.gz")
    SYNTH.save(path)
    return CacheFile.load(path)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's ``free_run`` outputs, from a subprocess: the eval
    counts, random search's exhaustion and the statistics cases."""
    n = SYNTH.space.compiled.n_valid
    spec = {f"evals/{name}": (name, EVAL_CASE) for name in NAMES}
    spec.update({f"stats/{name}": (name, STAT_CASE) for name in NAMES})
    spec["exhaust"] = ("random_search",
                       {"runs": 4, "seed": 2, "popsize": EXHAUST_P,
                        "generations": -(-n // EXHAUST_P) + 2})
    out = tmp_path_factory.mktemp("free_run_ref") / "ref.npz"
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([str(REPO / "src"),
                                          str(REPO / "tests")])}
    proc = subprocess.run([sys.executable, "-c", _REF_SCRIPT,
                           json.dumps(spec), str(out)], env=env, cwd=REPO,
                          capture_output=True, text=True,
                          timeout=REF_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as data:
        return {k: data[k] for k in data.files}


def _run(cache, name, **kw):
    return frs.free_run(cache, name, device="cpu", **kw)


def _numpy_best(cache_ref, name, budget, repeats):
    """Best values of ``repeats`` runs of the reference's numpy strategy,
    seeded as tests/test_engine_jax.py seeds them."""
    best = []
    for i in range(repeats):
        runner = RefRunner(cache_ref, RefBudget(max_seconds=budget),
                           engine="numpy")
        ref_get_strategy(name).run(cache_ref.space, runner,
                                   random.Random(1000 + i))
        best.append(runner.best.value)
    return np.asarray(best)


def _within_spread(mine, other):
    """tests/test_engine_jax.py's check: the means differ by less than 3x
    the other side's spread."""
    assert np.isfinite(mine).all()
    spread = float(np.max(other) - np.min(other)) or 1e-9
    assert abs(float(np.mean(mine)) - float(np.mean(other))) < 3 * spread


def _check_invariants(cache, out, runs, G, max_seconds=None,
                      max_evals=None):
    """The shape and budget invariants of tests/test_engine_jax.py, and
    best rows that are valid rows holding their best value."""
    compiled = cache.space.compiled
    assert out["curve_spent"].shape == (runs, G)
    assert out["curve_best"].shape == (runs, G)
    for k in ("best_value", "best_row", "spent_seconds", "spent_evals",
              "fresh_evals", "exhausted"):
        assert out[k].shape == (runs,), k
    assert (out["fresh_evals"] == out["spent_evals"]).all()
    # compares, not diffs: a run with no finite best yet has inf - inf
    assert (out["curve_spent"][:, 1:] >= out["curve_spent"][:, :-1]).all()
    assert (out["curve_best"][:, 1:] <= out["curve_best"][:, :-1]).all()
    assert np.array_equal(out["curve_spent"][:, -1], out["spent_seconds"])
    assert np.array_equal(out["curve_best"][:, -1], out["best_value"])
    if max_evals is not None:
        assert (out["spent_evals"] <= max_evals).all()
    if max_seconds is not None:
        # one commit may cross the cap: it is checked before the eval
        charge = cache.columns.charge_s
        assert (out["spent_seconds"] < max_seconds + charge.max()).all()
    finite = np.isfinite(out["best_value"])
    rows = out["best_row"][finite]
    assert ((rows >= 0) & (rows < compiled.n_valid)).all()
    cols = cache.columns.rows_for_space(compiled)[rows]
    assert (cols >= 0).all()
    assert np.array_equal(cache.columns.time_s[cols],
                          out["best_value"][finite])
    assert (out["best_row"][~finite] == -1).all()


# ------------------------------------------- tests/test_engine_jax.py, ported
@pytest.mark.parametrize("name", NAMES)
def test_free_run_pinned_seed_reproduces_bitwise(cache, name):
    kw = {"runs": 8, "seed": 5, "generations": 12,
          "max_seconds": TOTAL * 0.3}
    a, b = _run(cache, name, **kw), _run(cache, name, **kw)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        assert np.array_equal(a[k], b[k]), k
    c = _run(cache, name, **{**kw, "seed": 6})
    assert not np.array_equal(a["curve_spent"], c["curve_spent"])


@pytest.mark.parametrize("name", NAMES)
def test_free_run_budget_and_shape_invariants(cache, name):
    out = _run(cache, name, **EVAL_CASE)
    _check_invariants(cache, out, EVAL_CASE["runs"],
                      EVAL_CASE["generations"], max_evals=40)


@pytest.mark.parametrize("name", NAMES)
def test_free_run_time_budget_invariants(cache, name):
    """A time cap that runs out mid-campaign: every run stops, and its
    state and budget freeze from that generation on."""
    budget = TOTAL * 0.05
    out = _run(cache, name, runs=8, seed=4, generations=30,
               max_seconds=budget)
    _check_invariants(cache, out, 8, 30, max_seconds=budget)
    assert out["exhausted"].all()
    assert (out["spent_seconds"] >= budget).all()


def test_free_run_random_search_exhausts_space_exactly(cache):
    """Unbudgeted random search over enough generations covers every row
    exactly once: fresh == n_valid, best == optimum, spend == total
    charge (up to float summation order)."""
    compiled = cache.space.compiled
    G = -(-compiled.n_valid // EXHAUST_P) + 2
    out = _run(cache, "random_search", runs=4, seed=2, generations=G,
               popsize=EXHAUST_P)
    assert (out["fresh_evals"] == compiled.n_valid).all()
    optimum = min(r.time_s for r in SYNTH.results.values()
                  if r.status == "ok")
    assert np.array_equal(out["best_value"], np.full(4, optimum))
    assert np.allclose(out["spent_seconds"], TOTAL, rtol=1e-10)
    assert not out["exhausted"].any()


@pytest.mark.parametrize("name", NAMES)
def test_free_run_statistically_matches_numpy(cache, name):
    """Mean best value of the port's runs lands within 3x the spread of
    the reference's numpy strategy under the same budget (the reference
    checks the GA; each strategy is held here)."""
    out = _run(cache, name, **STAT_CASE)
    _within_spread(out["best_value"],
                   _numpy_best(SYNTH, name, STAT_CASE["max_seconds"], 24))


def test_free_run_rejects_unknown_hyperparameters(cache):
    with pytest.raises(ValueError, match="unknown hyperparameters"):
        _run(cache, "pso", runs=2, generations=2, crossover="uniform")


# ----------------------------------------------- against the reference's own
@pytest.mark.parametrize("name", NAMES)
def test_eval_counts_match_reference(cache, ref, name):
    out = _run(cache, name, **EVAL_CASE)
    for k in ("spent_evals", "fresh_evals"):
        assert np.array_equal(out[k], np.full(EVAL_CASE["runs"], 40)), k
        assert np.array_equal(out[k], ref[f"evals/{name}/{k}"]), k


def test_random_search_exhaustion_matches_reference(cache, ref):
    n = cache.space.compiled.n_valid
    out = _run(cache, "random_search", runs=4, seed=2, popsize=EXHAUST_P,
               generations=-(-n // EXHAUST_P) + 2)
    assert np.array_equal(out["fresh_evals"], ref["exhaust/fresh_evals"])
    assert np.array_equal(out["best_value"], ref["exhaust/best_value"])
    assert np.allclose(out["spent_seconds"], ref["exhaust/spent_seconds"],
                       rtol=1e-10, atol=0)
    assert np.array_equal(out["exhausted"], ref["exhaust/exhausted"])


@pytest.mark.parametrize("name", NAMES)
def test_statistically_matches_reference(cache, ref, name):
    """Under 0.25 of the total charge, the port's mean best value lies
    within 3x the spread of the reference's ``free_run`` runs, and so
    does its mean spend (PSO's revisits leave some runs short of the
    budget in 40 generations, on both sides)."""
    out = _run(cache, name, **STAT_CASE)
    _within_spread(out["best_value"], ref[f"stats/{name}/best_value"])
    _within_spread(out["spent_seconds"], ref[f"stats/{name}/spent_seconds"])


# ------------------------------------------------ a space with invalid configs
def hotspot_cache(seed: int = 0, recorded: float = 0.6) -> CacheFile:
    """The hotspot space (5,040 valid configs of 6,144), a seeded share of
    it recorded, like ``chip_smoke.synthetic_gemm_cache``: the rest replay
    as misses charged the mean charge."""
    space = hs.space()
    rng = np.random.default_rng(seed)
    n = space.size
    times = np.exp(rng.normal(-4.0, 1.0, n))
    keep = rng.random(n) < recorded
    failed = rng.random(n) < 0.2
    results = {}
    for i, conf in enumerate(space.valid_configs):
        if not keep[i]:
            continue
        results[space.config_id(conf)] = (
            CachedResult("error", float("inf"), (),
                         float(rng.random()) * 1e-3)
            if failed[i] else
            CachedResult("ok", float(times[i]), (float(times[i]),) * 3,
                         float(times[i])))
    return CacheFile("hotspot", "synthetic", space, results)


@pytest.fixture(scope="module")
def hot():
    return hotspot_cache()


def test_decode_repairs_invalid_configs(hot):
    """Continuous positions over the hotspot space decode to valid rows
    only, though many round to invalid configs first."""
    compiled = hot.space.compiled
    st = space_tables(compiled, "cpu")
    g = torch.Generator().manual_seed(0)
    c = frs._Ctx(st, "cpu", 4, 64, {}, g)
    x = torch.rand((4, 64, st.n_tunables), generator=g,
                   dtype=torch.float64) * st.x_hi
    raw = c.rows_of(torch.round(x))
    assert (raw < 0).sum() > 20  # the repair path has work to do
    rows = c.decode(x)
    assert ((rows >= 0) & (rows < compiled.n_valid)).all()
    assert torch.equal(rows[raw >= 0], raw[raw >= 0])


@pytest.mark.parametrize("name", NAMES)
def test_free_run_on_a_space_with_invalid_configs(hot, name):
    total = float(hot.columns.charge_s.sum())
    budget = total * 0.3
    out = _run(hot, name, runs=6, seed=3, generations=25,
               max_seconds=budget)
    _check_invariants(hot, out, 6, 25, max_seconds=budget)
    assert (out["fresh_evals"] > 0).all()


def test_random_search_exhausts_a_partly_recorded_space(hot):
    """Every valid row once: recorded rows charge their charge, the rest
    the mean charge; the best is the recording's optimum."""
    compiled = hot.space.compiled
    n = compiled.n_valid
    out = _run(hot, "random_search", runs=3, seed=7, popsize=EXHAUST_P,
               generations=-(-n // EXHAUST_P) + 2)
    cols = hot.columns.rows_for_space(compiled)
    assert (cols < 0).any()
    charge = np.where(cols >= 0, hot.columns.charge_s[cols],
                      hot.mean_eval_charge())
    assert (out["fresh_evals"] == n).all()
    assert np.allclose(out["spent_seconds"], charge.sum(), rtol=1e-10)
    assert (out["best_value"] == hot.optimum).all()


# ------------------------------------------------------------------ tables
def test_space_tables_are_memoized_per_device(hot):
    compiled = hot.space.compiled
    st = space_tables(compiled, "cpu")
    assert space_tables(compiled, "cpu") is st
    assert st.vidx.dtype == torch.int32 and st.row_of_flat.dtype == torch.int32
    assert st.strides.dtype == torch.int64 and st.x_hi.dtype == torch.float64
    assert np.array_equal(st.vidx.numpy(), compiled.vidx)
    assert np.array_equal(st.row_of_flat.numpy(), compiled.row_of_flat)
    assert compiled.__getstate__()["_device"] is None
    assert replay_tables(hot.columns, compiled, "cpu").has_miss


def test_exports():
    assert engine_torch.free_run is frs.free_run
    assert engine_torch.FREE_RUN_STRATEGIES is frs.FREE_RUN_STRATEGIES
    assert set(engine_torch.FREE_RUN_STRATEGIES) == {
        "genetic_algorithm", "pso", "differential_evolution",
        "random_search"}
    assert engine_torch.space_tables is space_tables


def test_whole_recording_has_no_miss(cache):
    rt = replay_tables(cache.columns, cache.space.compiled, "cpu")
    assert not rt.has_miss


def test_random_search_popsize_above_space_raises(cache):
    n = cache.space.compiled.n_valid
    with pytest.raises(ValueError, match="popsize"):
        _run(cache, "random_search", runs=2, generations=2, popsize=n + 1)


def test_default_device_is_the_card(cache):
    """With no device named, free_run means the card and raises where
    there is none (no silent fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        frs.free_run(cache, "genetic_algorithm", runs=2, generations=2)

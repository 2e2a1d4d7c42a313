"""The port's replay engine against the reference's numpy engine.

``repro_torch``'s ``SimulationRunner(engine="torch", device="cpu")`` runs
the budget-scan kernel's plain PyTorch version on the CPU; it is held
against ``repro.core.runner.SimulationRunner(engine="numpy")``, the oracle
the reference's own jax engine was held against. Both load the same cache
file (``_synth.parity_cache`` saved to ``tmp_path``). Tolerance: none —
every observation, trace entry, budget float and exhaustion point must be
bit-identical. The CUDA kernel is held against the plain version on the
card by chip_smoke.py and tests/test_torch_cuda.py.
"""
import math
import pickle

import numpy as np
import pytest
import torch
from _compat import given, settings, st
from _synth import parity_cache, total_charge

from repro.core.budget import Budget as RefBudget
from repro.core.budget import BudgetExhausted as RefExhausted
from repro.core.cache import CacheFile as RefCacheFile
from repro.core.runner import SimulationRunner as RefRunner
from repro.core.searchspace import SearchSpace as RefSearchSpace
from repro.core.space import RowBatch as RefRowBatch
from repro.core.tunable import tunables_from_dict as ref_tunables_from_dict
from repro_torch.core import engine_torch
from repro_torch.core.budget import Budget, BudgetExhausted
from repro_torch.core.cache import CacheFile, result_from_json
from repro_torch.core.runner import SimulationRunner
from repro_torch.core.searchspace import SearchSpace
from repro_torch.core.space import RowBatch
from repro_torch.core.tunable import tunables_from_dict

SYNTH = parity_cache()
TOTAL = total_charge(SYNTH)


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """The same cache file, loaded once by each package."""
    path = str(tmp_path_factory.mktemp("replay") / "parity.json.gz")
    SYNTH.save(path)
    return RefCacheFile.load(path), CacheFile.load(path)


def _observable(r):
    return ([(t, v, tuple(c)) for t, v, c in r.trace], r.fresh_evals,
            r.budget.spent_seconds, r.budget.spent_evals, sorted(r.memo))


def _obs(observations):
    return [(o.config, o.value, o.status, o.charge_s, o.result.status,
             o.result.time_s, o.result.times_s, o.result.compile_s,
             o.result.overhead_s) for o in observations]


def _pair(ref_cache, cache, **budget_kw):
    return (RefRunner(ref_cache, RefBudget(**budget_kw), engine="numpy"),
            SimulationRunner(cache, Budget(**budget_kw), engine="torch",
                             device="cpu"))


def _run(runner, rows, ref: bool):
    """Run one index-native ask; returns (observations | None, exhausted)."""
    batch = (RefRowBatch if ref else RowBatch)(
        runner.space.compiled, np.asarray(rows, dtype=np.int64))
    try:
        return runner.run_batch(batch), False
    except (RefExhausted if ref else BudgetExhausted):
        return None, True


def _same(ref_r, ours, rows):
    a = _run(ref_r, rows, ref=True)
    b = _run(ours, rows, ref=False)
    assert a[1] == b[1]
    if a[0] is not None:
        assert _obs(a[0]) == _obs(b[0])
    assert _observable(ref_r) == _observable(ours)
    return b[1]


def test_whole_space_with_revisits_bit_identical(caches):
    n = caches[1].space.compiled.n_valid
    ref_r, ours = _pair(*caches, max_seconds=1e9)
    assert not _same(ref_r, ours, np.r_[np.arange(n), np.arange(n)])
    assert ours.torch_engine().dispatches == 1


@pytest.mark.parametrize("budget_kw", [
    {"max_seconds": TOTAL * 0.21}, {"max_evals": 57},
    {"max_seconds": TOTAL * 0.35, "max_evals": 57}],
    ids=["seconds", "evals", "both"])
def test_budget_exhaustion_mid_batch_matches(caches, budget_kw):
    ref_r, ours = _pair(*caches, **budget_kw)
    assert _same(ref_r, ours, np.arange(caches[1].space.compiled.n_valid))
    if "max_evals" in budget_kw and "max_seconds" not in budget_kw:
        assert ours.budget.spent_evals == 57


def test_inf_failures_flow_through_trace(caches):
    ref_r, ours = _pair(*caches, max_seconds=1e9)
    _same(ref_r, ours, np.arange(caches[1].space.compiled.n_valid))
    assert [t for t in ours.trace if math.isinf(t[1])]


def test_cache_miss_rows_impute_mean_charge(tmp_path):
    cache = parity_cache(name="missy")
    for key in list(cache.results)[::5]:
        del cache.results[key]
    cache.invalidate_columns()
    path = str(tmp_path / "missy.json")
    cache.save(path)
    ref_cache, ours_cache = RefCacheFile.load(path), CacheFile.load(path)
    # the full space (not the membership space of the file), so the
    # deleted configs are misses, not outside the space
    tunables = {t.name: t.values for t in cache.space.tunables}
    ref_cache.space = RefSearchSpace(ref_tunables_from_dict(tunables),
                                     name="missy")
    ours_cache.space = SearchSpace(tunables_from_dict(tunables), name="missy")
    ref_r, ours = _pair(ref_cache, ours_cache, max_seconds=1e9)
    _same(ref_r, ours, np.arange(ours_cache.space.compiled.n_valid))
    misses = [o for o in ours.memo.values()
              if o.status == "error" and not o.result.times_s
              and o.charge_s == ours_cache.mean_eval_charge()]
    assert misses


def test_empty_cache_stays_on_host_and_raises_same_error(tmp_path):
    cache = parity_cache(name="empty")
    path = str(tmp_path / "empty.json")
    cache.save(path)
    errors = {}
    for tag, cls, budget, loader in (
            ("numpy", RefRunner, RefBudget, RefCacheFile.load),
            ("torch", SimulationRunner, Budget, CacheFile.load)):
        c = loader(path)
        c.results.clear()
        c.invalidate_columns()
        kw = {"engine": "numpy"} if tag == "numpy" else \
            {"engine": "torch", "device": "cpu"}
        runner = cls(c, budget(max_seconds=1e9), **kw)
        with pytest.raises(ValueError) as exc:
            _run(runner, np.arange(4), ref=tag == "numpy")
        errors[tag] = str(exc.value)
        if tag == "torch":
            assert runner.torch_engine().dispatches == 0
    assert errors["numpy"] == errors["torch"]


def test_single_row_asks_dispatch(caches):
    """Single-move shapes go through the scan too — no host shortcut."""
    ref_r, ours = _pair(*caches, max_seconds=1e9)
    for r in range(5):
        _same(ref_r, ours, [r])
    _same(ref_r, ours, [0])  # revisit: memo gather, no dispatch
    assert ours.torch_engine().dispatches == 5
    assert ours.fresh_evals == 5


def test_resume_reseeds_row_state(caches):
    ref_r, ours = _pair(*caches, max_evals=48)
    _same(ref_r, ours, np.arange(30))
    ours2 = SimulationRunner(caches[1], Budget(max_evals=48), engine="torch",
                             device="cpu")
    ours2.load_state_dict(ours.state_dict())
    assert _same(ref_r, ours2, np.arange(10, 60))


def test_replay_many_per_run_parity(caches):
    ref_cache, cache = caches
    compiled, cols = cache.space.compiled, cache.columns
    runs, n = 8, compiled.n_valid
    rng = np.random.default_rng(7)
    rows = np.stack([rng.permutation(n) for _ in range(runs)])
    max_s = TOTAL * 0.4
    accept, t_after, value, charge, spent, evals, exhausted = (
        o.numpy() for o in engine_torch.replay_many(
            cols, compiled, rows, max_seconds=max_s, device="cpu"))
    for r in range(runs):
        runner = RefRunner(ref_cache, RefBudget(max_seconds=max_s))
        _objs, exh = _run(runner, rows[r], ref=True)
        assert exh == bool(exhausted[r])
        assert runner.budget.spent_seconds == spent[r]
        assert runner.budget.spent_evals == evals[r]
        acc = accept[r]
        assert [t for t, _v, _c in runner.trace] == t_after[r][acc].tolist()
        assert [v for _t, v, _c in runner.trace] == value[r][acc].tolist()


def test_replay_many_seen_basis_makes_revisits_free(caches):
    cache = caches[1]
    compiled = cache.space.compiled
    seen = np.zeros(compiled.n_valid, dtype=bool)
    seen[::2] = True
    accept, _t, _v, _c, _s, evals, _x = engine_torch.replay_many(
        cache.columns, compiled, np.arange(compiled.n_valid)[None, :],
        seen=seen, device="cpu")
    assert not accept[0][::2].any() and accept[0][1::2].all()
    assert int(evals[0]) == compiled.n_valid // 2


def test_replay_many_rejects_rows_outside_the_space(caches):
    cache = caches[1]
    with pytest.raises(IndexError):
        engine_torch.replay_many(cache.columns, cache.space.compiled,
                                 np.array([[0, cache.space.compiled.n_valid]]),
                                 device="cpu")


def test_tables_memoized_float64_and_never_pickled(caches):
    cache = caches[1]
    compiled, cols = cache.space.compiled, cache.columns
    rt = engine_torch.replay_tables(cols, compiled, "cpu")
    assert engine_torch.replay_tables(cols, compiled, "cpu") is rt
    assert (rt.time_s.dtype, rt.charge_s.dtype, rt.col_of_row.dtype) == \
        (torch.float64, torch.float64, torch.int32)
    assert pickle.loads(pickle.dumps(cols))._device is None
    assert cols._device is not None
    runner = SimulationRunner(cache, Budget(max_seconds=1e9), engine="torch",
                              device="cpu")
    _run(runner, [0, 1, 2], ref=False)
    clone = pickle.loads(pickle.dumps(runner))
    assert clone._torch_eng is None and clone.device == "cpu"
    assert pickle.loads(pickle.dumps(cache))._columns is None


def test_plain_scan_matches_sequential_python_loop():
    """The plain version against the scalar float64 loop it stands for,
    with misses, padding (fresh=False) and per-run budgets."""
    rng = np.random.default_rng(3)
    runs, n, v = 6, 40, 30
    rows = rng.integers(0, v, (runs, n))
    fresh = rng.random((runs, n)) < 0.8
    col = np.where(rng.random(v) < 0.2, -1, rng.permutation(v)).astype(np.int32)
    time_s, charge_s = rng.random(v), rng.random(v)
    max_s = rng.random(runs) * 10
    max_e = rng.integers(1, 40, runs)
    out = engine_torch.budget_scan(
        *(torch.from_numpy(x) for x in (rows, fresh, col, time_s, charge_s)),
        0.37, torch.zeros(runs, dtype=torch.float64),
        torch.zeros(runs, dtype=torch.int64), torch.from_numpy(max_s),
        torch.from_numpy(max_e))
    accept, t_after, _value, charge, spent, evals, exhausted = \
        (o.numpy() for o in out)
    for r in range(runs):
        s, e, exh = 0.0, 0, False
        for j in range(n):
            c = 0.37 if col[rows[r, j]] < 0 else charge_s[col[rows[r, j]]]
            assert charge[r, j] == c
            ok = bool(fresh[r, j]) and s < max_s[r] and e < max_e[r]
            if ok:
                s += c
                e += 1
            exh |= bool(fresh[r, j]) and not ok
            assert accept[r, j] == ok and t_after[r, j] == s
        assert (spent[r], evals[r], exhausted[r]) == (s, e, exh)


def test_scan_wrapper_validates_types():
    z = torch.zeros(2, 4, dtype=torch.int64)
    with pytest.raises(ValueError, match="fresh"):
        engine_torch.budget_scan(
            z, z, torch.zeros(4, dtype=torch.int32),
            torch.zeros(4, dtype=torch.float64),
            torch.zeros(4, dtype=torch.float64), 0.0,
            torch.zeros(2, dtype=torch.float64),
            torch.zeros(2, dtype=torch.int64),
            torch.zeros(2, dtype=torch.float64),
            torch.zeros(2, dtype=torch.int64))


def test_torch_engine_without_cuda_raises_unless_cpu(caches):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SimulationRunner(caches[1], Budget(max_seconds=1.0), engine="torch")
    with pytest.raises(RuntimeError):
        engine_torch.replay_many(caches[1].columns,
                                 caches[1].space.compiled, [[0]])
    assert not engine_torch.engine_available()


@given(st.integers(0, 10_000))
@settings(max_examples=20, deadline=None)
def test_property_random_batches_bit_identical(seed):
    """Random row batches (duplicates, revisits across calls, varying
    sizes) under random budgets: full observable parity."""
    ref_cache = SYNTH
    rng = np.random.default_rng(seed)
    n = SYNTH.space.compiled.n_valid
    frac = 0.05 + (seed % 13) / 20.0
    budget_kw = ({"max_evals": 10 + seed % 120} if seed % 3 == 0
                 else {"max_seconds": TOTAL * frac})
    ref_r = RefRunner(ref_cache, RefBudget(**budget_kw), engine="numpy")
    ours = SimulationRunner(_PORT_SYNTH, Budget(**budget_kw), engine="torch",
                            device="cpu")
    for _ in range(3):
        rows = rng.integers(0, n, int(rng.integers(1, 120)))
        if _same(ref_r, ours, rows):
            break


def _port_synth():
    """``_synth.parity_cache`` carried into the port through its JSON form
    (the T4 format both packages read)."""
    d = SYNTH.to_json()
    space = SearchSpace(tunables_from_dict(d["tunables"]), name="parity")
    return CacheFile(d["kernel"], d["device"], space,
                     {k: result_from_json(r) for k, r in d["results"].items()})


_PORT_SYNTH = _port_synth()


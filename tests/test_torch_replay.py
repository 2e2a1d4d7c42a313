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
import pathlib
import pickle
import re

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



# ------------------------------------------------------ the kernel's design
# csrc/budget_scan.cu's chunk shape, read from the source so the mirror
# below follows the kernel
_SCAN_SRC = (pathlib.Path(engine_torch.__file__).parent / "csrc"
             / "budget_scan.cu").read_text()
SLOTS = int(re.search(r"constexpr int kSlots = (\d+);", _SCAN_SRC).group(1))
CHUNK = 32 * SLOTS


def _scan_mirror(rows, fresh, col_of_row, time_s, charge_s, mean_charge,
                 spent0, evals0, max_s, max_e, reassociate=False):
    """csrc/budget_scan.cu's warp in numpy, one run at a time: chunks of
    ``CHUNK`` entries, entry k = 32·s + lane of a chunk owned by ``lane``
    in slot ``s``; all lanes gather col, value and charge at once (value
    and charge written whatever the budget), one ballot of fresh a slot;
    one lane walks the chunk's charges in entry order, slot by slot while
    the slot holds entries, adding each fresh charge and writing the spend
    back in place; then each lane checks the caps against the spend before
    its entry (the slot before, or the chunk's start) and the count before
    it (the fresh bits below it in its slot, on the count of the slots
    before); the first refusal cuts the chunk and freezes the run, whose
    later chunks take accept 0 and the frozen spend without a walk.
    ``reassociate`` sums the chunk's fresh charges first and adds the sums
    to the spend, the one change the kernel must not make."""
    runs, n = rows.shape
    accept = np.zeros((runs, n), dtype=bool)
    t_after = np.empty((runs, n))
    value = np.empty((runs, n))
    charge = np.empty((runs, n))
    spent_out = np.empty(runs)
    evals_out = np.empty(runs, dtype=np.int64)
    exhausted = np.zeros(runs, dtype=bool)
    lane = np.arange(32)
    for r in range(runs):
        spent, evals, frozen = np.float64(spent0[r]), int(evals0[r]), False
        cap_s, cap_e = max_s[r], int(max_e[r])
        for j0 in range(0, n, CHUNK):
            ln = min(n - j0, CHUNK)
            k = np.arange(CHUNK)
            inside = k < ln
            col = np.full(CHUNK, -1, dtype=np.int64)
            col[inside] = col_of_row[rows[r, j0:j0 + ln]]
            safe = np.maximum(col, 0)
            c = np.where(col < 0, mean_charge, charge_s[safe])
            value[r, j0:j0 + ln] = np.where(col < 0, np.inf,
                                            time_s[safe])[:ln]
            charge[r, j0:j0 + ln] = c[:ln]
            fm = np.zeros(CHUNK, dtype=bool)
            fm[:ln] = fresh[r, j0:j0 + ln]
            fm = fm.reshape(SLOTS, 32)
            if frozen:
                t_after[r, j0:j0 + ln] = spent
                continue
            chain = c.copy()
            if reassociate:
                part = np.cumsum(np.where(fm.ravel(), c, 0.0))
                chain = spent + part
            else:
                t = spent
                for s in range(SLOTS):
                    if 32 * s >= ln:
                        break
                    for i in range(32 * s, 32 * s + 32):
                        if fm[s, i % 32]:
                            t = t + chain[i]
                        chain[i] = t
            cut, ev = CHUNK, evals
            for s in range(SLOTS):
                kk = 32 * s + lane
                before = np.where(kk == 0, spent, chain[kk - 1])
                ev_before = ev + np.cumsum(fm[s]) - fm[s]
                refused = fm[s] & ~((before < cap_s) & (ev_before < cap_e))
                if cut == CHUNK and refused.any():
                    cut = 32 * s + int(np.argmax(refused))
                if cut == CHUNK:
                    ev += int(fm[s].sum())
            stop = spent
            if cut < CHUNK:
                stop = spent if cut == 0 else chain[cut - 1]
                ev += int(fm[cut // 32, :cut % 32].sum())
            kk = np.arange(ln)
            accept[r, j0:j0 + ln] = (kk < cut) & fm.ravel()[:ln]
            t_after[r, j0:j0 + ln] = np.where(kk < cut, chain[:ln], stop)
            spent = stop if cut < CHUNK else chain[ln - 1]
            evals, frozen = ev, cut < CHUNK
        spent_out[r], evals_out[r], exhausted[r] = spent, evals, frozen
    return accept, t_after, value, charge, spent_out, evals_out, exhausted


def _scalar_scan(rows, fresh, col_of_row, time_s, charge_s, mean_charge,
                 spent0, evals0, max_s, max_e):
    """The scan's semantics as the scalar float64 commit loop."""
    runs, n = rows.shape
    out = (np.zeros((runs, n), dtype=bool), np.empty((runs, n)),
           np.empty((runs, n)), np.empty((runs, n)), np.empty(runs),
           np.empty(runs, dtype=np.int64), np.zeros(runs, dtype=bool))
    accept, t_after, value, charge, spent_o, evals_o, exh_o = out
    for r in range(runs):
        s, e, exh = float(spent0[r]), int(evals0[r]), False
        for j in range(n):
            col = col_of_row[rows[r, j]]
            value[r, j] = np.inf if col < 0 else time_s[col]
            charge[r, j] = mean_charge if col < 0 else charge_s[col]
            ok = bool(fresh[r, j]) and s < max_s[r] and e < max_e[r]
            if ok:
                s += charge[r, j]
                e += 1
            exh |= bool(fresh[r, j]) and not ok
            accept[r, j], t_after[r, j] = ok, s
        spent_o[r], evals_o[r], exh_o[r] = s, e, exh
    return out


def _scan_inputs(cap: str, where: str, n: int, runs: int = 3, seed: int = 0):
    """Inputs of the scan with misses (col -1), non-fresh entries and
    charges of varied scale; ``cap`` is what runs out ("time", "count",
    "both" or "none": inf and 2**62), ``where`` the entry of the first
    refusal ("first", "last", "chunk" (the first of the second chunk),
    "slot" (the first of the second slot) or "random")."""
    rng = np.random.default_rng(seed)
    v = 97
    rows = rng.integers(0, v, (runs, n))
    fresh = rng.random((runs, n)) < 0.85
    col = np.where(rng.random(v) < 0.15, -1,
                   rng.permutation(v)).astype(np.int32)
    time_s = rng.random(v)
    charge_s = rng.random(v) * 10.0 ** rng.integers(-3, 3, v)
    mean_charge = 0.37
    spent0 = rng.random(runs) * 5.0
    evals0 = rng.integers(0, 4, runs)
    max_s = np.full(runs, np.inf)
    max_e = np.full(runs, 2 ** 62, dtype=np.int64)
    free = (rows, fresh, col, time_s, charge_s, mean_charge, spent0, evals0,
            max_s, max_e)
    if cap == "none":
        return free
    # the refused entry: fresh, with a positive charge before it so the
    # spend before it is above every earlier spend
    at = {"first": 0, "last": n - 1, "chunk": CHUNK, "slot": 32,
          "random": int(rng.integers(0, n))}[where]
    at = min(at, n - 1)
    fresh[:, at] = True
    if at:
        fresh[:, at - 1] = True
    scalar = _scalar_scan(*free)
    for r in range(runs):
        before_s = spent0[r] if at == 0 else scalar[1][r, at - 1]
        before_e = evals0[r] + int(scalar[0][r, :at].sum())
        if cap in ("time", "both"):
            max_s[r] = before_s
        if cap in ("count", "both"):
            max_e[r] = before_e
    return free


def _torch_args(args):
    return tuple(torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray)
                 else a for a in args)


def _same_scan(a, b) -> bool:
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b))


@pytest.mark.parametrize("n", [1, 31, CHUNK - 1, CHUNK + 1, 2 * CHUNK + 40])
@pytest.mark.parametrize("cap,where", [
    ("time", "first"), ("time", "last"), ("time", "chunk"),
    ("count", "first"), ("count", "last"), ("count", "slot"),
    ("both", "random"), ("none", "random")])
def test_scan_mirror_bit_identical_to_plain_and_scalar(cap, where, n):
    """The numpy mirror of the kernel's warp equals ``budget_scan_plain``
    and the scalar loop bit for bit, with misses, non-fresh entries and
    refusals at the first entry, the last, a chunk edge and a slot edge."""
    args = _scan_inputs(cap, where, n)
    got = _scan_mirror(*args)
    plain = [o.numpy() for o in engine_torch.budget_scan_plain(
        *_torch_args(args))]
    assert _same_scan(got, plain)
    assert _same_scan(got, _scalar_scan(*args))
    refused = args[1] & ~got[0]
    if cap == "none":
        assert not refused.any()
    else:  # every run's first refusal is the chosen entry
        at = {"first": 0, "last": n - 1, "chunk": CHUNK, "slot": 32}.get(
            where)
        assert refused.any(axis=1).all()
        if at is not None:
            assert (np.argmax(refused, axis=1) == min(at, n - 1)).all()


def test_scan_mirror_fails_when_reassociated():
    """The mirror test can fail: summing a chunk's charges before adding
    them to the spend changes the low bits of t_after."""
    args = _scan_inputs("none", "random", 2 * CHUNK + 40, runs=4, seed=5)
    plain = [o.numpy() for o in engine_torch.budget_scan_plain(
        *_torch_args(args))]
    assert _same_scan(_scan_mirror(*args), plain)
    assert not _same_scan(_scan_mirror(*args, reassociate=True), plain)


@pytest.mark.parametrize("cap,where", [("time", "slot"), ("none", "random")])
def test_plain_scan_writes_into_out(cap, where):
    """``budget_scan_plain(out=...)`` fills the given tensors (here views
    into one packed block, as the CPU path of the packed call passes them)
    with the results it returns when it allocates its own."""
    args = _torch_args(_scan_inputs(cap, where, 64))
    want = engine_torch.budget_scan_plain(*args)
    rp = engine_torch.replay
    layout = rp.ScanLayout(3, 64)
    block = torch.full((layout.nbytes["out"],), 0xA5, dtype=torch.uint8)
    views = layout.views(block, rp.OUT_FIELDS)
    out = tuple(views[name] for name in rp.OUT_ORDER)
    got = engine_torch.budget_scan_plain(*args, out=out)
    assert all(g is o for g, o in zip(got, out))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("runs", [1, 3, 1024])
@pytest.mark.parametrize("npad", [8, 16, 32, 1024, 16384])
def test_scan_layout_offsets_are_8_byte_aligned(runs, npad):
    layout = engine_torch.replay.ScanLayout(runs, npad)
    for fields, block in ((engine_torch.replay.IN_FIELDS, "in"),
                          (engine_torch.replay.OUT_FIELDS, "out")):
        end = 0
        for name, dtype, per in fields:
            off = layout.offsets[name]
            assert off % 8 == 0 and off == end
            end = off + layout.numel(per) * dtype.itemsize
        assert layout.nbytes[block] % 8 == 0 and layout.nbytes[block] >= end
        assert [f[1].itemsize for f in fields] == sorted(
            (f[1].itemsize for f in fields), reverse=True)


@pytest.mark.parametrize("batch", [1, 20], ids=["sa", "ga"])
def test_packed_commit_rows_matches_numpy_engine(caches, batch):
    """``commit_rows`` through the packed blocks, on simulated-annealing-
    (one row) and GA-sized (20 rows, a population) batches with revisits,
    against the numpy engine until the budget runs out; the blocks grow to
    the largest padded length and keep it."""
    ref_r, ours = _pair(*caches, max_seconds=TOTAL * 0.3)
    rng = np.random.default_rng(batch)
    n = caches[1].space.compiled.n_valid
    sizes = []
    while True:
        size = batch if batch == 1 else int(rng.integers(batch - 12, batch + 1))
        sizes.append(size)
        if _same(ref_r, ours, rng.integers(0, n, size)):
            break
    blocks = ours.torch_engine().blocks()
    assert blocks.device == torch.device("cpu")
    assert blocks.capacity == engine_torch.replay._pad_len(max(sizes))
    assert ours.torch_engine().dispatches >= len(sizes) // 2

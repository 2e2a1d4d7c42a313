"""The port's hypertuner (``repro_torch.core.hypertuner``) against the
reference's, and the whole slice: four hub kernels recorded by the port,
then tuned with the tuner, in both packages.

Scores are compared with ``==``: the port's strategies, replay and scoring
are bit-identical to the reference's (the torch engine commits the same
float64 sums as the numpy engine), so every hyperconfiguration's
aggregate score must be the same float. Every campaign here runs over
recordings on which the genetic algorithm ends: ``_assert_ga_ends``
checks, before any campaign, that the methodology's budget runs out
before a run could have visited every recorded configuration (ROADMAP
Queue 3: otherwise the GA restarts forever, in both packages).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from _synth import parity_cache

import repro.core.hypertuner as ref_ht
import repro.core.methodology as ref_meth
from repro.core.cache import CacheFile as RefCacheFile
from repro.core.parallel import CampaignJournal as RefJournal
from repro_torch.core import hypertuner as ht
from repro_torch.core import methodology, record
from repro_torch.core.cache import CacheFile
from repro_torch.core.parallel import CampaignJournal
from repro_torch.kernels import gemm as gm
from repro_torch.kernels import get_kernel

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
GA = "genetic_algorithm"
HUB = ("gemm", "convolution", "hotspot", "dedispersion")


def _assert_ga_ends(scorers):
    for s in scorers:
        charges = s.cache.columns.charge_s
        assert s.budget_s < float(charges.sum()) - float(charges.max()), \
            f"{s.name}: the GA would restart forever on this recording"


@pytest.fixture(scope="module")
def cache_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("hypertune")
    paths = [str(d / "parity.json.gz"), str(d / "second.json")]
    parity_cache().save(paths[0])
    parity_cache(n_a=16, n_b=3, name="second", fail_every=7).save(paths[1])
    return paths


def _ours(paths, engine):
    scorers = [methodology.make_scorer(CacheFile.load(p), engine=engine,
                                       device="cpu") for p in paths]
    _assert_ga_ends(scorers)
    return scorers


def _ref(paths):
    return [ref_meth.make_scorer(RefCacheFile.load(p)) for p in paths]


@pytest.fixture(scope="module")
def ref_exhaustive(cache_paths):
    return ref_ht.exhaustive_hypertune(GA, _ref(cache_paths), repeats=2)


def _same_results(ours, ref):
    assert list(ours.results) == list(ref.results)
    assert len(ours.results) == 108
    for hp_id, r in ref.results.items():
        o = ours.results[hp_id]
        assert o.hyperparams == r.hyperparams
        assert o.score == r.score, hp_id
        assert np.array_equal(o.report.curve, r.report.curve)
        assert o.report.per_space_score == r.report.per_space_score
        assert (o.report.fresh_evals, o.report.simulated_seconds) == \
            (r.report.fresh_evals, r.report.simulated_seconds)
    assert ours.simulated_seconds == ref.simulated_seconds


@pytest.mark.parametrize("engine", ["torch", "vectorized"])
def test_exhaustive_hypertune_equals_reference(cache_paths, ref_exhaustive,
                                               engine):
    ours = ht.exhaustive_hypertune(GA, _ours(cache_paths, engine), repeats=2)
    _same_results(ours, ref_exhaustive)
    assert ours.best.hyperparams == ref_exhaustive.best.hyperparams
    assert ours.closest_to_mean().score == \
        ref_exhaustive.closest_to_mean().score
    assert ours.worst.score == ref_exhaustive.worst.score


def test_hyperparam_grids_equal_reference():
    for extended, size in ((False, 108), (True, 4 * 25 * 20 * 20)):
        ours = ht.hyperparam_searchspace(GA, extended=extended)
        ref = ref_ht.hyperparam_searchspace(GA, extended=extended)
        assert ours.size == ref.size == size
        assert ours.valid_configs == ref.valid_configs
    with pytest.raises(ValueError, match="no hyperparameters"):
        ht.hyperparam_searchspace("random_search")


def _ga_ends(path):
    s = methodology.make_scorer(CacheFile.load(path), engine="vectorized")
    charges = s.cache.columns.charge_s
    return s.budget_s < float(charges.sum()) - float(charges.max())


@pytest.fixture(scope="module")
def slice_recordings(tmp_path_factory):
    """One cache per hub kernel, recorded by the port on the CPU (the plain
    versions) at its SMOKE_PROBLEM, each on a warmed-up kernel.

    On the CPU the plain versions ignore the tiling, so a recording's times
    are noise around one value, the methodology's budget lands near 95 % of
    the recording's charge, and one slow outlier evaluation can push it
    past the point where the GA ends. A recording that fails
    ``_ga_ends`` is made again with the next seed."""
    d = tmp_path_factory.mktemp("slice")
    paths = []
    for name in HUB:
        spec0 = get_kernel(name)
        space = spec0.space()
        fn = spec0.make_live(device="cpu")
        fn(next(space.as_dict(c) for c in space.valid_configs
                if name != "gemm" or gm.fits(space.as_dict(c),
                                             torch.bfloat16)))
        for seed in range(1, 9):
            out = str(d / f"{name}-{seed}.json.gz")
            spec = record.RecordSpec.create(name, target="cpu", repeats=1,
                                            max_evals=240 if name == "gemm"
                                            else 100, seed=seed)
            record.record_cache(spec, out)
            if _ga_ends(out):
                break
        paths.append(out)
    return paths


def test_whole_slice_hypertunes_like_the_reference(slice_recordings):
    """Record the four hub kernels with the port, load the recordings in
    both packages, and tune the GA's hyperparameters across the four:
    every hyperconfiguration scores the same."""
    ours_scorers = _ours(slice_recordings, "torch")
    ref_scorers = _ref(slice_recordings)
    assert [s.name for s in ours_scorers] == [s.name for s in ref_scorers] \
        == [f"{k}@cpu" for k in HUB]
    for a, b in zip(ours_scorers, ref_scorers):
        assert (a.budget_s, a.optimum, a.n_total) == \
            (b.budget_s, b.optimum, b.n_total)
    ours = ht.exhaustive_hypertune(GA, ours_scorers, repeats=1)
    ref = ref_ht.exhaustive_hypertune(GA, ref_scorers, repeats=1)
    _same_results(ours, ref)
    assert all(len(r.report.per_space_score) == 4
               for r in ours.results.values())


def test_meta_hypertune_equals_reference(cache_paths):
    kw = dict(extended=False, max_hp_evals=8, repeats=2, seed=3)
    ours = ht.meta_hypertune(GA, "random_search",
                             _ours(cache_paths, "torch"), **kw)
    ref = ref_ht.meta_hypertune(GA, "random_search", _ref(cache_paths), **kw)
    assert ours.best_hyperparams == ref.best_hyperparams
    assert ours.best_score == ref.best_score
    assert ours.evaluated == ref.evaluated and len(ours.evaluated) == 8
    assert ours.simulated_seconds == ref.simulated_seconds
    assert [t[:2] for t in ours.trace] == [t[:2] for t in ref.trace]


def _truncate_journal(path, keep):
    """Keep the header and the first ``keep`` records, as a campaign
    killed after ``keep`` configurations leaves its journal."""
    lines = pathlib.Path(path).read_text().splitlines(keepends=True)
    pathlib.Path(path).write_text("".join(lines[:1 + keep]))


def test_interrupted_exhaustive_journal_resumes_without_rescoring(
        cache_paths, ref_exhaustive, tmp_path):
    path = str(tmp_path / "campaign.jsonl")
    scorers = _ours(cache_paths, "vectorized")
    ht.exhaustive_hypertune(GA, scorers, repeats=2,
                            journal=CampaignJournal(path))
    _truncate_journal(path, 40)
    scored = []
    resumed = ht.exhaustive_hypertune(GA, scorers, repeats=2,
                                      journal=CampaignJournal(path),
                                      progress=scored.append)
    assert scored[0] == f"resumed 40/108 configs from {path}"
    assert len(scored) == 1 + 68        # only the missing ones are scored
    _same_results(resumed, ref_exhaustive)
    header, records = RefJournal(path).read()   # the reference reads it
    assert header["mode"] == "exhaustive" and len(records) == 108


def test_interrupted_meta_journal_resumes_to_the_same_result(cache_paths,
                                                             tmp_path):
    """Random search asks its whole permutation at once, so the journal
    holds no mid-run snapshot before the end: a campaign cut after 3
    evaluations resumes by replaying the meta-strategy against the
    memoized ones, re-scoring none of them."""
    kw = dict(extended=False, max_hp_evals=8, repeats=2, seed=3)
    scorers = _ours(cache_paths, "vectorized")
    full = ht.meta_hypertune(GA, "random_search", scorers, **kw)
    path = str(tmp_path / "meta.jsonl")
    ht.meta_hypertune(GA, "random_search", scorers,
                      journal=CampaignJournal(path), **kw)
    _truncate_journal(path, 3)
    header, records = CampaignJournal(path).read()
    assert header["mode"] == "meta" and len(records) == 3
    assert all(r.get("type") != "checkpoint" for r in records)
    log = []
    resumed = ht.meta_hypertune(GA, "random_search", scorers,
                                journal=CampaignJournal(path),
                                progress=log.append, **kw)
    assert log[0] == f"resumed 3 evaluations from {path}"
    assert len(log) == 1 + 8
    assert (resumed.best_hyperparams, resumed.best_score,
            resumed.evaluated) == \
        (full.best_hyperparams, full.best_score, full.evaluated)
    _, records = CampaignJournal(path).read()
    assert len([r for r in records if r.get("type") != "checkpoint"]) == 8


def test_results_to_cache_round_trips(cache_paths, ref_exhaustive, tmp_path):
    ours = ht.exhaustive_hypertune(GA, _ours(cache_paths, "vectorized"),
                                   repeats=2)
    cache = ht.results_to_cache(ours)
    ref_cache = ref_ht.results_to_cache(ref_exhaustive)
    a, b = str(tmp_path / "ours.json"), str(tmp_path / "ref.json")
    cache.save(a)
    ref_cache.save(b)
    assert pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes()
    loaded = CacheFile.load(a)
    assert list(loaded.results) == list(cache.results)
    for key, r in cache.results.items():
        assert loaded.results[key].time_s == r.time_s
        assert loaded.results[key].charge_s == r.charge_s
    best = min(cache.results.values(), key=lambda r: r.time_s)
    assert -best.time_s == ours.best.score
    # the meta level scores like any space
    meta = methodology.make_scorer(loaded, engine="vectorized")
    ref_meta = ref_meth.make_scorer(RefCacheFile.load(b))
    assert (meta.budget_s, meta.optimum) == (ref_meta.budget_s,
                                             ref_meta.optimum)


def _env():
    return {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu"}


def _run(*argv):
    r = subprocess.run([sys.executable, "-m", *argv], capture_output=True,
                       text=True, env=_env(), timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout


def _line(text, prefix):
    return next(line for line in text.splitlines() if line.startswith(prefix))


def test_cli_hypertune_and_report(cache_paths, ref_exhaustive, tmp_path):
    """``hypertune`` prints the reference's optimal-vs-average line for the
    same campaign; ``report`` reads it back from the journal; ``meta`` runs
    with the torch engine on the CPU."""
    journal = str(tmp_path / "cli.jsonl")
    caches = [arg for path in cache_paths for arg in ("--cache", path)]
    out = _run("repro_torch", "hypertune", "--strategy", GA, *caches,
               "--repeats", "2", "--quiet", "--top", "3", "--engine",
               "vectorized", "--journal", journal)
    best, avg = ref_exhaustive.best, ref_exhaustive.closest_to_mean()
    rel = (best.score - avg.score) / max(abs(avg.score), 1e-2)
    want = (f"optimal vs average config: {best.score:+.4f} vs "
            f"{avg.score:+.4f} ({100*rel:+.1f}%")
    assert _line(out, "optimal vs average") == \
        want + "; paper Sec. IV-B reports +94.8% on average)"
    assert "campaign: 108 configs" in out
    report = _run("repro_torch", "report", journal, "--top", "3")
    assert "progress: 108/108 configurations" in report
    assert _line(report, "optimal vs average") == want + ")"
    assert "spaces: parity@synth, second@synth" in report
    meta = _run("repro_torch", "meta", "--strategy", GA, "--meta-strategy",
                "random_search", "--table3-grid", "--max-hp-evals", "4",
                "--cache", cache_paths[1], "--repeats", "1", "--quiet",
                "--device", "cpu")
    assert "after 4 of 108 grid points" in meta
    r = subprocess.run([sys.executable, "-m", "repro_torch", "hypertune",
                        "--strategy", "random_search", "--cache",
                        cache_paths[0], "--device", "cpu"],
                       capture_output=True, text=True, env=_env(),
                       timeout=300)
    assert r.returncode != 0 and "no hyperparameters" in r.stderr

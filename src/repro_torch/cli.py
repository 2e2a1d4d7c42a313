"""Command line of the port: ``python -m repro_torch <subcommand>``.

Port of ``src/repro/cli.py``, with the subcommands of this slice's path:

  record      strategy-sample a registered kernel live on the card (or its
              plain version on the CPU) into a replayable T4 cache
  bruteforce  exhaustively record a registered kernel's valid space
  merge-cache fold recording shards into one canonical cache file
              (``--hub-root`` also registers the merge into a hub and
              evicts stale service index entries)
  simulate    score one strategy configuration with the methodology in
              simulation mode (paper Sec. III-B/C, Eqs. 2–3)
  hypertune   exhaustive hyperparameter-grid campaign (Sec. IV-B,
              Table III), parallel (``--workers``) and resumable
              (``--journal``)
  meta        meta-strategy hyperparameter optimization (Sec. IV-C,
              Eq. 4), journaled for resume
  report      inspect a campaign journal: ranking, optimal-vs-average
              improvement, wall-clock parallelism
  spaces      per-space statistics for the selected hub/cache spaces and
              the strategies' hyperparameter grids
  lookup      best known config for (kernel, problem shape, device) from
              the recorded hub: exact hit, nearest-shape transfer with
              confidence, roofline-modeled answer, or cold (exit 3)
  serve       line-oriented lookup service: JSON requests on stdin, one
              ``LookupResult`` JSON per line on stdout
  scenarios   the scenario matrix: every (kernel x shape x device) triple
              with its coverage tier (recorded | modeled | cold), optional
              best times, JSON artifact output, and the recorded best-time
              regression gate
  fleet       run/resume the recording fleet over the scenario matrix:
              record -> merge -> register each runnable triple into the
              hub, journaled so re-runs skip completed work
  hub         hub dataset management: build, info, verify (sha256 every
              indexed file), stats (includes the coverage matrix)
  lint        parity-lint: determinism and pickle-safety static analysis
              of the port (``repro_torch.analysis``)

Flags mirror ``repro``'s flags of the same names, with one difference:
``--device`` names where the work runs (``cuda``, the default, or
``cpu``), and a live recording is labelled with the card's name. The
lookup verb's ``--device`` names the key's device, as in the reference (a
device model, or a recorded label such as the card's name); there
``cuda`` and ``cpu`` stand for the label of that live device, where a
warm-start flight records. The scoring commands (``simulate``,
``hypertune``, ``meta``) take their spaces from repeatable ``--cache``
files; ``spaces`` also reads a hub selection.
"""
from __future__ import annotations

import argparse
import ast
import os
import sys
import time
from typing import Sequence

from .core import record as rec
from .core.cache import CacheFile
from .core.hypertuner import (HyperConfigResult, HyperTuningResult,
                              exhaustive_hypertune, hyperparam_searchspace,
                              meta_hypertune)
from .core.methodology import evaluate_strategy, make_scorer
from .core.parallel import (CampaignExecutor, CampaignJournal,
                            StrategyFactory, report_from_json)
from .core.strategies import STRATEGIES
from .kernels import FRAMEWORK_KERNELS, HUB_KERNELS, KERNELS

KERNEL_HELP = (f"a registered kernel: hub tier {', '.join(HUB_KERNELS)}; "
               f"framework tier {', '.join(FRAMEWORK_KERNELS)}")
STRATEGY_HELP = f"one of {', '.join(STRATEGIES)}"


def _parse_kv(text: str | None, flag: str) -> dict:
    """Parse ``k=v,k2=v2`` with Python-literal values (``0.05``, ``True``,
    ``'greedy'``); bare words fall back to strings."""
    out: dict = {}
    for item in filter(None, (text or "").split(",")):
        key, sep, raw = item.partition("=")
        if not sep:
            raise SystemExit(f"{flag}: expected k=v, got {item!r}")
        try:
            out[key.strip()] = ast.literal_eval(raw.strip())
        except (ValueError, SyntaxError):
            out[key.strip()] = raw.strip()
    return out


def _run_recording(args, bruteforce: bool) -> int:
    mode = "bruteforce" if bruteforce else "record"
    t0 = time.perf_counter()
    spec = rec.RecordSpec.create(
        args.kernel, target=args.device,
        problem=_parse_kv(args.problem, "--problem"),
        strategy=getattr(args, "strategy", "random_search"),
        hyperparams=_parse_kv(getattr(args, "hyperparams", None),
                              "--hyperparams"),
        repeats=args.repeats, max_evals=args.max_evals,
        max_seconds=args.seconds, seed=args.seed)
    out = args.out or f"recorded/{args.kernel}@{spec.device}.json.gz"
    cache = rec.record_cache(spec, out, bruteforce=bruteforce,
                             progress=lambda msg: print(f"  {msg}",
                                                        flush=True))
    ok = [(r.time_s, k) for k, r in cache.results.items() if r.status == "ok"]
    print(f"{mode}: {len(cache.results)}/{cache.space.size} configs recorded "
          f"({len(ok)} ok) for {args.kernel}@{spec.device} in "
          f"{time.perf_counter() - t0:.1f} s wall")
    if ok:
        best, key = min(ok)
        print(f"best: {cache.space.as_dict(cache.space.config_from_id(key))}"
              f" ({best * 1e3:.3f} ms)")
    print(f"cache: {out}")
    print(f"replay: python -m repro_torch simulate --strategy random_search "
          f"--cache {out}")
    return 0


def cmd_record(args) -> int:
    """Strategy-sampled live recording of a registered kernel."""
    return _run_recording(args, bruteforce=False)


def cmd_bruteforce(args) -> int:
    """Exhaustive live recording (paper Table II: brute-forcing a space)."""
    return _run_recording(args, bruteforce=True)


def cmd_merge_cache(args) -> int:
    """Merge recording shards into one canonical cache file."""
    header, _ = rec.ObservationShard(args.shards[0]).read()
    if header is None:
        raise SystemExit(f"{args.shards[0]} has no shard header")
    space = rec.registry_space(header.get("kernel", ""),
                               header.get("problem"))
    cache = rec.merge_shards(args.shards, space=space)
    cache.save(args.out)
    print(f"merged {cache.meta['n_shards']} shards -> {args.out}: "
          f"{cache.meta['n_configs']} configs ({cache.meta['n_ok']} ok) "
          f"for {cache.kernel}@{cache.device}")
    if args.hub_root:
        from .api import Hub
        # a recording's problem overrides the kernel's smoke sizes; the
        # hub keys shapes in full
        problem = header.get("problem") or None
        if cache.kernel in KERNELS:
            problem = KERNELS[cache.kernel].problem(problem)
        key = Hub(args.hub_root).register(cache, problem=problem)
        print(f"registered in hub {args.hub_root} as {key} "
              f"(live lookup indexes invalidated)")
    return 0


def cmd_simulate(args) -> int:
    """Score one strategy configuration (paper Sec. III-B, Eqs. 2–3)."""
    scorers = [make_scorer(CacheFile.load(path), engine=args.engine,
                           device=args.device) for path in args.cache]
    factory = StrategyFactory.create(args.strategy,
                                     _parse_kv(args.hyperparams,
                                               "--hyperparams"))
    report = evaluate_strategy(factory, scorers, repeats=args.repeats,
                               seed=args.seed)
    for name, score in sorted(report.per_space_score.items()):
        print(f"  {name:28s} {score:+.4f}")
    print(f"aggregate score (Eq. 3): {report.score:+.4f}  "
          f"[{args.strategy} x{args.repeats} repeats, "
          f"{len(report.per_space_score)} spaces, engine {args.engine}"
          + (f" on {scorers[0].device}" if args.engine == "torch" else "")
          + "]")
    print(f"simulated {report.simulated_seconds:.2f} s of tuning in "
          f"{report.wall_seconds:.2f} s wall ({report.fresh_evals} fresh "
          f"evaluations, drive: {report.fuse})")
    return 0


def _scorers(args) -> list:
    return [make_scorer(CacheFile.load(path), engine=args.engine,
                        device=args.device) for path in args.cache]


def _progress(quiet: bool):
    return None if quiet else (lambda msg: print(msg, flush=True))


def _journal(path: str | None) -> CampaignJournal | None:
    return CampaignJournal(path) if path else None


def _print_ranking(results: dict, top: int) -> None:
    ranked = sorted(results.items(), key=lambda kv: -kv[1].score)
    for hp_id, r in ranked[:top]:
        print(f"  {r.score:+.4f}  {hp_id}")
    if len(ranked) > top:
        print(f"  ... {len(ranked) - top} more "
              f"(worst {ranked[-1][1].score:+.4f})")


def cmd_hypertune(args) -> int:
    """Exhaustive hyperparameter tuning (paper Sec. IV-B, Table III)."""
    scorers = _scorers(args)
    with CampaignExecutor(workers=args.workers,
                          backend=args.backend) as executor:
        res = exhaustive_hypertune(args.strategy, scorers,
                                   repeats=args.repeats, seed=args.seed,
                                   progress=_progress(args.quiet),
                                   executor=executor,
                                   journal=_journal(args.journal))
    _print_ranking(res.results, args.top)
    best, avg = res.best, res.closest_to_mean()
    rel = (best.score - avg.score) / max(abs(avg.score), 1e-2)
    print(f"optimal vs average config: {best.score:+.4f} vs {avg.score:+.4f}"
          f" ({100*rel:+.1f}%; paper Sec. IV-B reports +94.8% on average)")
    print(f"campaign: {len(res.results)} configs, "
          f"{res.simulated_seconds/3600:.2f} simulated h replayed in "
          f"{res.wall_seconds:.1f} s wall ({args.workers} workers, "
          f"engine {args.engine}"
          + (f" on {scorers[0].device}" if args.engine == "torch" else "")
          + f", drive: {best.report.fuse})")
    if args.journal:
        print(f"journal: {args.journal}")
    return 0


def cmd_meta(args) -> int:
    """Meta-strategy hyperparameter tuning (paper Sec. IV-C, Eq. 4)."""
    scorers = _scorers(args)
    with CampaignExecutor(workers=args.workers,
                          backend=args.backend) as executor:
        res = meta_hypertune(args.strategy, args.meta_strategy, scorers,
                             extended=not args.table3_grid,
                             max_hp_evals=args.max_hp_evals,
                             repeats=args.repeats, seed=args.seed,
                             meta_hyperparams=_parse_kv(
                                 args.meta_hyperparams, "--meta-hyperparams"),
                             progress=_progress(args.quiet),
                             executor=executor,
                             journal=_journal(args.journal))
    grid = hyperparam_searchspace(args.strategy,
                                  extended=not args.table3_grid)
    print(f"best hyperparameters for {args.strategy} "
          f"(found by {args.meta_strategy}): {res.best_hyperparams}")
    print(f"score {res.best_score:+.4f} after {len(res.evaluated)} of "
          f"{grid.size} grid points ({res.wall_seconds:.1f} s wall"
          + (f", drive: {res.fuse}" if res.fuse else "") + ")")
    if res.wall_seconds > 0 and res.simulated_seconds:
        print(f"simulated {res.simulated_seconds/3600:.2f} h of tuning "
              f"replayed in {res.wall_seconds:.1f} s wall "
              f"({res.simulated_seconds / res.wall_seconds:,.0f}x)")
    if args.journal:
        print(f"journal: {args.journal}")
    return 0


def cmd_report(args) -> int:
    """Summarize a campaign journal (no recomputation)."""
    header, records = CampaignJournal(args.journal).read()
    if header is None:
        raise SystemExit(f"no journal at {args.journal}")
    mode = header.get("mode", "?")
    print(f"campaign: {mode} {header.get('strategy')} "
          f"(repeats={header.get('repeats')}, seed={header.get('seed')})")
    print(f"spaces: {', '.join(header.get('spaces', []))}")
    snapshots = [r for r in records if r.get("type") == "checkpoint"]
    records = [r for r in records if r.get("type") != "checkpoint"]
    if not records:
        print("no completed evaluations yet")
        return 0
    if mode == "exhaustive":
        results = {r["hp_id"]: HyperConfigResult(
            r["hyperparams"], report_from_json(r["report"]))
            for r in records}
        grid = hyperparam_searchspace(header["strategy"])
        print(f"progress: {len(results)}/{grid.size} configurations")
        _print_ranking(results, args.top)
        res = HyperTuningResult(header["strategy"], results, 0.0, 0.0)
        best, avg = res.best, res.closest_to_mean()
        rel = (best.score - avg.score) / max(abs(avg.score), 1e-2)
        print(f"optimal vs average config: {best.score:+.4f} vs "
              f"{avg.score:+.4f} ({100*rel:+.1f}%)")
        modes = {r.report.fuse for r in results.values()}
        print(f"drive: {modes.pop() if len(modes) == 1 else 'mixed'}")
        work = sum(r.report.wall_seconds for r in results.values())
    else:
        ranked = sorted(records, key=lambda r: -r["score"])[:args.top]
        for r in ranked:
            print(f"  {r['score']:+.4f}  {r['hp_id']}")
        if snapshots:
            print(f"mid-run state snapshots: {len(snapshots)} "
                  f"(resume continues inside the tuning run)")
        work = 0.0
    done_wall = max(r.get("done_wall", 0.0) for r in records)
    simulated = sum(r["report"]["simulated_seconds"] if "report" in r
                    else r["simulated_seconds"] for r in records)
    print(f"simulated tuning replayed: {simulated/3600:.2f} h")
    if done_wall:
        rate = 60.0 * len(records) / done_wall
        print(f"campaign wall: {done_wall:.1f} s "
              f"({rate:.1f} configs/min)")
        print(f"simulated-vs-wall speedup: {simulated/done_wall:,.0f}x")
    if work and done_wall:
        print(f"aggregate worker compute: {work:.1f} s -> "
              f"average parallelism {work/done_wall:.2f}x")
    return 0


def cmd_spaces(args) -> int:
    """Per-space stats (thin over ``repro_torch.api.describe_space``)."""
    from .api import Tuner, hyperparam_space_stats

    def row(st: dict) -> str:
        adj, ham = st["degrees"]["strictly_adjacent"], st["degrees"]["hamming"]
        return (f"  {st['name']:32s} {st['cartesian_size']:>9d} "
                f"{st['n_valid']:>8d} {st['valid_fraction']:>6.1%} "
                f"{adj['median']:>5.1f}/{adj['max']:<4d} "
                f"{ham['median']:>6.1f}/{ham['max']:<5d} "
                f"{st['compile_seconds']*1e3:>8.1f}")

    header = (f"  {'space':32s} {'cartesian':>9s} {'valid':>8s} {'frac':>6s} "
              f"{'adj med/max':>10s} {'ham med/max':>12s} {'compile ms':>9s}")
    tuner = Tuner(caches=args.cache or None,
                  kernels=_csv(args.kernels), devices=_csv(args.devices),
                  split=args.split, hub_root=args.hub_root)
    print("search spaces (hub/cache selection):")
    print(header)
    for st in tuner.space_stats():
        print(row(st))
    print(f"hyperparameter grids "
          f"({'Table IV extended' if args.extended else 'Table III'}):")
    print(header)
    for st in hyperparam_space_stats(extended=args.extended):
        print(row(st))
    return 0


def _csv(text: str | None) -> list | None:
    return text.split(",") if text else None


def _live_alias(name: str) -> bool:
    """Does a lookup's device name the live device (``cuda``, ``cuda:N``,
    ``cpu``) rather than a device model or a recorded label?"""
    return name in ("cuda", "cpu") or name.startswith("cuda:")


def _lookup_hub(args, live: str | None = None):
    """A ``ConfigHub`` from the shared lookup/serve options; ``live`` is
    where a warm-start flight records (the card unless ``"cpu"``)."""
    from .hub import DEFAULT_ROOT
    from .service import ConfigHub
    warm: bool | dict = False
    if getattr(args, "warm_start", False):
        warm = {"max_evals": args.warm_max_evals, "device": live}
    return ConfigHub(args.hub_root or DEFAULT_ROOT,
                     verify=not args.no_verify,
                     ttl_s=getattr(args, "ttl", None), warm_start=warm)


def _print_lookup(r, as_json: bool) -> None:
    import json as _json
    if as_json:
        print(_json.dumps(r.to_json()))
        return
    print(f"{r.kernel}@{r.device} "
          f"{'{' + ', '.join(f'{k}={v}' for k, v in r.problem.items()) + '}'}"
          f": {r.status} (confidence {r.confidence:.2f})")
    if r.best_config is not None:
        val = (f"{r.best_value * 1e3:.3f} ms"
               if r.best_value not in (None, float('inf')) else "n/a")
        kind = "modeled" if r.status == "modeled" else "recorded ok"
        print(f"  best: {r.best_config} ({val}, over {r.n_configs} "
              f"{kind} configs)")
    if r.status == "transfer":
        print(f"  donor: {r.source} problem={r.donor_problem} "
              f"shape-distance {r.distance:.3f}")
    elif r.status == "modeled" and r.model:
        print(f"  model: {r.model['model']} on {r.model['device_model']} "
              f"({r.model['dominant']}-bound, "
              f"{r.model['n_ok']}/{r.model['n_valid']} configs feasible)")
    elif r.source:
        print(f"  source: {r.source}")
    print(f"  resolved in {r.wall_seconds * 1e6:.0f} us")


def cmd_lookup(args) -> int:
    """One-shot service lookup against the recorded hub."""
    from .cuda import device_label, resolve_device
    live, device = None, args.device
    if _live_alias(device):
        live = resolve_device(device)
        device = device_label(live)
    hub = _lookup_hub(args, live)
    problem = _parse_kv(args.problem, "--problem") or None
    r = hub.lookup(args.kernel, problem, device)
    if args.wait and r.status == "warming" and hub.warm_start is not None:
        flight = hub.warm_start.ensure(args.kernel, device, r.problem)
        flight.join(args.wait)
        r = hub.lookup(args.kernel, problem, device)
    _print_lookup(r, args.json)
    return 0 if r.found else 3


def serve_requests(hub, lines):
    """The ``serve`` loop, factored for tests: yields one result dict per
    input line. A line is a JSON object (one request: ``kernel`` plus
    optional ``problem``/``device``) or a JSON array of them (batched
    through ``lookup_many``). Bad lines yield an ``error`` dict instead of
    killing the service."""
    import json as _json
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            req = _json.loads(line)
            if isinstance(req, list):
                for r in hub.lookup_many(req):
                    yield r.to_json()
            else:
                yield hub.lookup(req["kernel"], req.get("problem"),
                                 req.get("device", "tpu_v5e")).to_json()
        except (ValueError, KeyError, TypeError) as e:
            yield {"error": f"{type(e).__name__}: {e}", "request": line}


def cmd_serve(args) -> int:
    """Stdin/stdout lookup service (one JSON request per line)."""
    import json as _json
    hub = _lookup_hub(args, args.device)
    if args.warm_up:
        n = hub.warm_up()
        print(f"warmed {n} hub entries", file=sys.stderr, flush=True)
    print(f"serving lookups over {hub.root} "
          f"(entries: {hub.stats()['entries']}); one JSON request per "
          f"line, e.g. {{\"kernel\": \"gemm\", \"device\": \"tpu_v5e\"}}",
          file=sys.stderr, flush=True)
    for result in serve_requests(hub, sys.stdin):
        print(_json.dumps(result), flush=True)
    stats = hub.stats()
    print(f"served {sum(stats['lookups'].values())} lookups "
          f"({stats['lookups']}); {stats['disk_loads']} cache loads",
          file=sys.stderr)
    return 0


def _build_matrix(args):
    """A ``ScenarioMatrix`` from the shared --kernels/--devices CSVs; the
    live row is ``--device``'s label when --devices is not given."""
    from .scenarios import ScenarioMatrix
    return ScenarioMatrix(kernels=_csv(args.kernels),
                          devices=_csv(args.devices), device=args.device)


def cmd_scenarios(args) -> int:
    """Coverage report over the scenario matrix: every (kernel x shape x
    device) triple with its tier, optionally best times and the recorded
    best-time regression gate."""
    import json as _json

    from .hub import DEFAULT_ROOT
    from .scenarios import gate_recorded
    from .service import ConfigHub
    matrix = _build_matrix(args)
    hub = ConfigHub(args.hub_root or DEFAULT_ROOT, verify=not args.no_verify)
    with_best = args.best or bool(args.gate) or bool(args.out)
    report = matrix.coverage(hub, with_best=with_best)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            _json.dump(report.to_json(), f, indent=1)
            f.write("\n")
    if args.json:
        print(_json.dumps(report.to_json(), indent=1))
    else:
        for row in report.rows:
            best = ""
            if row.best_value is not None:
                best = f"  {row.best_value * 1e3:.3f} ms"
            print(f"  {row.scenario.key:58s} {row.tier:8s}{best}")
        counts = report.counts()
        total = sum(counts.values())
        print(f"{total} scenarios: " + ", ".join(
            f"{counts.get(t, 0)} {t}" for t in ("recorded", "modeled",
                                                "cold")))
    if args.gate:
        with open(args.gate, "r", encoding="utf-8") as f:
            baseline = _json.load(f)
        base_best = {r["key"]: r["best_value"]
                     for r in baseline.get("rows", [])
                     if r.get("tier") == "recorded"
                     and r.get("best_value") is not None}
        failures = gate_recorded(report.recorded_best(), base_best,
                                 threshold=args.threshold)
        if failures:
            for msg in failures:
                print(f"  GATE {msg}")
            print(f"{len(failures)} recorded-best regression(s) vs "
                  f"{args.gate}")
            return 1
        print(f"gate ok: {len(base_best)} recorded baselines within "
              f"{args.threshold:.0%}")
    return 0


def cmd_fleet(args) -> int:
    """Run/resume the recording fleet: record -> merge -> register every
    runnable triple of the matrix into the hub, journaled so completed
    scenarios are skipped on re-run."""
    import json as _json

    from .hub import DEFAULT_ROOT
    from .scenarios import run_fleet
    outcome = run_fleet(
        args.hub_root or DEFAULT_ROOT,
        matrix=_build_matrix(args),
        runner=args.runner, strategy=args.strategy,
        max_evals=args.max_evals, repeats=args.repeats,
        workers=args.workers, backend=args.backend, seed=args.seed,
        progress=_progress(args.quiet), device=args.device)
    if args.json:
        print(_json.dumps(outcome.to_json(), indent=1))
    else:
        print(f"fleet: {len(outcome.recorded)} recorded, "
              f"{len(outcome.skipped)} already journaled, "
              f"{len(outcome.covered)} already in hub, "
              f"{len(outcome.unrunnable)} unrunnable with "
              f"runner={args.runner}")
        for key in outcome.recorded:
            print(f"  recorded {key}")
    return 0


def cmd_hub(args) -> int:
    """Hub dataset management (build / info / verify / stats)."""
    import json as _json

    from .api import Hub
    hub = Hub(args.root)
    if args.action == "build":
        Hub.build(args.root, device=args.device, kernels=_csv(args.kernels),
                  devices=_csv(args.devices))
        m = hub.manifest
        print(f"hub built at {os.path.abspath(hub.root)} in "
              f"{m['build_wall_seconds']:.1f}s wall ({len(m['files'])} "
              f"entries)")
        return 0
    if args.action == "verify":
        failures = hub.verify(strict=False)
        entries = len(hub.manifest["files"])
        if failures:
            for key, reason in sorted(failures.items()):
                print(f"  FAIL {key}: {reason}")
            print(f"{len(failures)} of {entries} entries failed "
                  f"verification")
            return 1
        print(f"ok: all {entries} entries verified (sha256)")
        return 0
    if args.action == "info":
        print(_json.dumps(hub.manifest, indent=1))
        return 0
    print(_json.dumps(hub.stats(device=args.device), indent=1))  # stats
    return 0


PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
DEFAULT_BASELINE = os.path.join(PACKAGE_DIR, "analysis",
                                "parity-lint-baseline.json")


def cmd_lint(args) -> int:
    """parity-lint: the determinism/pickle-safety static-analysis gate
    (``repro_torch.analysis``; ``--list-rules`` prints the catalogue).
    Defaults: the package itself and its baseline."""
    import json as _json

    from .analysis import baseline as _baseline
    from .analysis import default_rules, lint_paths
    from .analysis.report import rule_catalogue, to_json, to_text

    rules = default_rules()
    if args.list_rules:
        print(rule_catalogue(rules))
        return 0
    paths = args.paths or [PACKAGE_DIR]
    for p in paths:
        if not os.path.exists(p):
            raise SystemExit(f"error: no such path: {p}")
    baseline_path = args.baseline
    if baseline_path is None and not args.no_baseline \
            and os.path.exists(DEFAULT_BASELINE):
        baseline_path = DEFAULT_BASELINE
    if args.no_baseline or args.write_baseline:
        baseline_path = None
    result = lint_paths(paths, baseline=baseline_path, rules=rules)
    if args.write_baseline:
        out = args.baseline or DEFAULT_BASELINE
        lines: dict = {}

        def line_text(f):
            if f.path not in lines:
                for root in paths:
                    cand = os.path.join(root, f.path)
                    if os.path.exists(cand):
                        with open(cand, "r", encoding="utf-8") as fh:
                            lines[f.path] = fh.read().splitlines()
                        break
                else:
                    lines[f.path] = []
            text = lines[f.path]
            return text[f.line - 1] if 1 <= f.line <= len(text) else ""

        n = _baseline.write(out, result.findings, line_text)
        print(f"wrote {n} baseline entr{'y' if n == 1 else 'ies'} "
              f"covering {len(result.findings)} finding(s) -> {out}")
        return 0
    if args.report:
        with open(args.report, "w", encoding="utf-8") as f:
            _json.dump(to_json(result, rules), f, indent=2)
            f.write("\n")
    if args.format == "json":
        print(_json.dumps(to_json(result, rules), indent=2))
    else:
        print(to_text(result))
    return 0 if result.ok else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro_torch",
        description="Tuning the Tuner on PyTorch/CUDA — live recording of "
                    "hand-written Hopper kernels and simulation-mode "
                    "scoring")
    sub = p.add_subparsers(dest="command", required=True)

    def add_record_args(pp, bruteforce: bool) -> None:
        pp.add_argument("--kernel", required=True, choices=sorted(KERNELS),
                        help=KERNEL_HELP)
        pp.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="where the kernel runs (default: the card); "
                             "cpu times the kernel's plain version")
        pp.add_argument("--problem", default=None, metavar="K=V,...",
                        help="problem-size overrides (e.g. m=4096,n=4096,"
                             "k=4096); default: the kernel's smoke sizes")
        pp.add_argument("--repeats", type=int, default=3,
                        help="observations per fresh live evaluation")
        if not bruteforce:
            pp.add_argument("--strategy", default="random_search",
                            choices=sorted(STRATEGIES),
                            help=f"recording strategy, {STRATEGY_HELP}")
            pp.add_argument("--hyperparams", default=None, metavar="K=V,...")
        pp.add_argument("--max-evals", type=int,
                        default=None if bruteforce else 64,
                        help="fresh-evaluation cap"
                             + (" (default unlimited)" if bruteforce
                                else " (default 64)"))
        pp.add_argument("--seconds", type=float, default=None,
                        help="measured-seconds cap")
        pp.add_argument("--out", default=None, metavar="PATH",
                        help="output cache (.json/.json.gz/.json.zst; "
                             "default recorded/<kernel>@<device>.json.gz); "
                             "its shard lands next to it and survives "
                             "crashes: rerun the same command to resume")
        pp.add_argument("--seed", type=int, default=0)

    def add_space_args(pp) -> None:
        pp.add_argument("--cache", action="append", required=True,
                        metavar="PATH", help="T4 cache file; repeatable")
        pp.add_argument("--repeats", type=int, default=25,
                        help="methodology repeats per space (paper uses 25)")
        pp.add_argument("--engine", choices=("torch", "vectorized", "scalar"),
                        default="torch",
                        help="torch replays every batch through the "
                             "budget-scan kernel; vectorized and scalar are "
                             "the numpy engines. Scores are bit-identical "
                             "across all three")
        pp.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="where the torch engine replays (default: the "
                             "card)")
        pp.add_argument("--seed", type=int, default=0)

    def add_exec_args(pp) -> None:
        pp.add_argument("--workers", type=int, default=1,
                        help="worker pool size (1 = serial; results are "
                             "bit-identical at any worker count)")
        pp.add_argument("--backend", choices=("auto", "thread", "process"),
                        default="auto", help="worker pool backend")

    prec = sub.add_parser("record", help="record a live tuning run of a "
                          "registered kernel into a replayable cache")
    add_record_args(prec, bruteforce=False)
    prec.set_defaults(fn=cmd_record)

    pbf = sub.add_parser("bruteforce", help="exhaustively record a "
                         "registered kernel's valid space")
    add_record_args(pbf, bruteforce=True)
    pbf.set_defaults(fn=cmd_bruteforce)

    pmc = sub.add_parser("merge-cache", help="merge recording shards into "
                         "one canonical T4 cache")
    pmc.add_argument("shards", nargs="+", metavar="SHARD")
    pmc.add_argument("--out", required=True, metavar="PATH")
    pmc.add_argument("--hub-root", default=None, metavar="DIR",
                     help="also register the merged cache in this hub's "
                          "manifest and invalidate live lookup services")
    pmc.set_defaults(fn=cmd_merge_cache)

    ps = sub.add_parser("simulate", help="score one strategy configuration "
                        "with the methodology (Sec. III-B)")
    ps.add_argument("--strategy", required=True, choices=sorted(STRATEGIES),
                    help=STRATEGY_HELP)
    ps.add_argument("--hyperparams", default=None, metavar="K=V,...",
                    help="strategy hyperparameters (default: DEFAULTS)")
    add_space_args(ps)
    ps.set_defaults(fn=cmd_simulate)

    ph = sub.add_parser("hypertune", help="exhaustive hyperparameter "
                        "campaign (Table III), parallel + resumable")
    ph.add_argument("--strategy", required=True, choices=sorted(STRATEGIES),
                    help=f"the strategy whose Table III grid is searched, "
                         f"{STRATEGY_HELP}")
    ph.add_argument("--journal", default=None, metavar="PATH",
                    help="JSONL checkpoint; rerun with the same path to "
                         "resume an interrupted campaign")
    ph.add_argument("--top", type=int, default=5,
                    help="show the N best configurations")
    ph.add_argument("--quiet", action="store_true")
    add_space_args(ph)
    add_exec_args(ph)
    ph.set_defaults(fn=cmd_hypertune)

    pm = sub.add_parser("meta", help="meta-strategy hyperparameter "
                        "optimization (Eq. 4, Table IV)")
    pm.add_argument("--strategy", required=True, choices=sorted(STRATEGIES),
                    help=f"the strategy being tuned, {STRATEGY_HELP}")
    pm.add_argument("--meta-strategy", required=True,
                    choices=sorted(STRATEGIES),
                    help=f"the strategy that searches its hyperparameters, "
                         f"{STRATEGY_HELP}")
    pm.add_argument("--max-hp-evals", type=int, default=50)
    pm.add_argument("--table3-grid", action="store_true",
                    help="search the small Table III grid instead of the "
                         "extended Table IV space")
    pm.add_argument("--meta-hyperparams", default=None, metavar="K=V,...")
    pm.add_argument("--journal", default=None, metavar="PATH")
    pm.add_argument("--quiet", action="store_true")
    add_space_args(pm)
    add_exec_args(pm)
    pm.set_defaults(fn=cmd_meta)

    pr = sub.add_parser("report", help="summarize a campaign journal")
    pr.add_argument("journal", metavar="JOURNAL",
                    help="path to a campaign JSONL journal")
    pr.add_argument("--top", type=int, default=10)
    pr.set_defaults(fn=cmd_report)

    live_help = ("where live work runs (default: the card); cpu runs the "
                 "kernels' plain versions")

    psp = sub.add_parser("spaces", help="per-space stats: sizes, valid "
                         "fraction, neighbor degrees, compile time")
    psp.add_argument("--cache", action="append", default=[], metavar="PATH",
                     help="T4 cache file; repeatable. Overrides the hub "
                          "options")
    psp.add_argument("--split", choices=("train", "test"), default="train",
                     help="hub device split (default train)")
    psp.add_argument("--kernels", default=None,
                     help="comma-separated hub kernels (default: all)")
    psp.add_argument("--devices", default=None,
                     help="comma-separated hub devices (overrides --split)")
    psp.add_argument("--hub-root", default=None, metavar="DIR",
                     help="hub directory (default: the repository's hub/)")
    psp.add_argument("--extended", action="store_true",
                     help="show the Table IV extended hyperparameter grids "
                          "instead of Table III")
    psp.set_defaults(fn=cmd_spaces)

    def add_lookup_args(pp, serve: bool) -> None:
        pp.add_argument("--hub-root", default=None, metavar="DIR",
                        help="hub directory (default: the repository's "
                             "hub/)")
        pp.add_argument("--no-verify", action="store_true",
                        help="skip sha256 verification when materializing "
                             "hub entries")
        pp.add_argument("--ttl", type=float, default=None, metavar="SECONDS",
                        help="re-stat materialized entries older than this "
                             "(default: only explicit invalidation)")
        pp.add_argument("--warm-start", action="store_true",
                        help="launch a journaled recording campaign "
                             "(single-flight) for cold keys: the cost model "
                             "for a device model, live for the live "
                             "device's label")
        pp.add_argument("--warm-max-evals", type=int, default=32,
                        help="fresh-eval budget of a warm-start campaign")
        if serve:
            pp.add_argument("--device", choices=("cuda", "cpu"),
                            default=None,
                            help="where a live warm-start flight records "
                                 "(default: the card)")
            return
        pp.add_argument("--kernel", required=True,
                        help="kernel name (hub or registry)")
        pp.add_argument("--device", default="tpu_v5e",
                        help="the key's device: a device model or a "
                             "recorded label (default tpu_v5e); cuda or cpu "
                             "mean that live device's label, where a "
                             "warm-start flight records")
        pp.add_argument("--problem", default=None, metavar="K=V,...",
                        help="problem sizes (default: the kernel's hub "
                             "shape)")
        pp.add_argument("--json", action="store_true",
                        help="print the LookupResult as JSON")
        pp.add_argument("--wait", type=float, default=None,
                        metavar="SECONDS",
                        help="with --warm-start: block up to SECONDS for "
                             "the campaign before answering")

    plk = sub.add_parser("lookup", help="best known config for (kernel, "
                         "problem, device) from the recorded hub")
    add_lookup_args(plk, serve=False)
    plk.set_defaults(fn=cmd_lookup)

    psv = sub.add_parser("serve", help="lookup service: JSON requests on "
                         "stdin, LookupResult JSON lines on stdout")
    add_lookup_args(psv, serve=True)
    psv.add_argument("--warm-up", action="store_true",
                     help="materialize every hub entry before serving")
    psv.set_defaults(fn=cmd_serve)

    def add_matrix_args(pp) -> None:
        pp.add_argument("--kernels", default=None,
                        help="comma-separated kernels (default: all "
                             "registered)")
        pp.add_argument("--devices", default=None,
                        help="comma-separated devices (default: hub "
                             "device models + the live device's label)")
        pp.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help=live_help)

    psc = sub.add_parser("scenarios", help="coverage over the scenario "
                         "matrix: every (kernel x shape x device) triple, "
                         "recorded | modeled | cold")
    add_matrix_args(psc)
    psc.add_argument("--hub-root", default=None, metavar="DIR",
                     help="hub directory (default: the repository's hub/)")
    psc.add_argument("--no-verify", action="store_true",
                     help="skip sha256 verification of hub entries")
    psc.add_argument("--best", action="store_true",
                     help="resolve and show the best time per triple")
    psc.add_argument("--json", action="store_true",
                     help="print the coverage report as JSON")
    psc.add_argument("--out", default=None, metavar="PATH",
                     help="also write the JSON report to PATH (the "
                          "artifact / gate baseline)")
    psc.add_argument("--gate", default=None, metavar="BASELINE",
                     help="fail if any recorded best time regressed vs "
                          "this earlier coverage JSON")
    psc.add_argument("--threshold", type=float, default=0.2,
                     help="allowed recorded-best slowdown for --gate "
                          "(default 0.2 = 20%%)")
    psc.set_defaults(fn=cmd_scenarios)

    pfl = sub.add_parser("fleet", help="run/resume the recording fleet "
                         "over the scenario matrix (journaled)")
    add_matrix_args(pfl)
    pfl.add_argument("--hub-root", default=None, metavar="DIR",
                     help="hub directory to register into (default: the "
                          "repository's hub/)")
    pfl.add_argument("--runner", choices=("live", "costmodel", "surrogate"),
                     default="costmodel",
                     help="recorder per triple (live records the live "
                          "device's row only; default costmodel)")
    pfl.add_argument("--strategy", default="random_search",
                     choices=sorted(STRATEGIES))
    pfl.add_argument("--max-evals", type=int, default=64,
                     help="fresh-evaluation cap per scenario (default 64)")
    pfl.add_argument("--repeats", type=int, default=3,
                     help="observations per fresh evaluation (default 3)")
    add_exec_args(pfl)
    pfl.add_argument("--seed", type=int, default=0)
    pfl.add_argument("--json", action="store_true",
                     help="print the fleet outcome as JSON")
    pfl.add_argument("--quiet", action="store_true")
    pfl.set_defaults(fn=cmd_fleet)

    phub = sub.add_parser("hub", help="hub dataset management: build, "
                          "info, verify (sha256), stats")
    phub.add_argument("action", choices=("build", "info", "verify", "stats"))
    phub.add_argument("--root", default=None,
                      help="hub directory (default: the repository's hub/)")
    phub.add_argument("--device", choices=("cuda", "cpu"), default=None,
                      help="build: where the framework kernels' smoke "
                           "recordings run; stats: the coverage's live row "
                           "(default: the card)")
    phub.add_argument("--kernels", default=None,
                      help="build: comma-separated kernels (default: all)")
    phub.add_argument("--devices", default=None,
                      help="build: comma-separated device models "
                           "(default: all six)")
    phub.set_defaults(fn=cmd_hub)

    pl = sub.add_parser("lint", help="parity-lint: determinism & "
                        "pickle-safety static analysis of the port")
    pl.add_argument("paths", nargs="*", metavar="PATH",
                    help="files/directories to lint (default: the "
                         "repro_torch package, src/repro_torch)")
    pl.add_argument("--baseline", default=None, metavar="PATH",
                    help="baseline of grandfathered findings (default: "
                         "src/repro_torch/analysis/parity-lint-baseline.json)")
    pl.add_argument("--no-baseline", action="store_true",
                    help="ignore any baseline file: report everything")
    pl.add_argument("--write-baseline", action="store_true",
                    help="write the current findings as the new baseline "
                         "(to --baseline or the default path) and exit 0")
    pl.add_argument("--format", choices=("text", "json"), default="text",
                    help="stdout format (json is the machine-readable "
                         "report, incl. the rule catalogue)")
    pl.add_argument("--report", default=None, metavar="PATH",
                    help="also write the JSON report to PATH, regardless "
                         "of --format")
    pl.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue (invariant + runtime "
                         "oracle per rule) and exit")
    pl.set_defaults(fn=cmd_lint)
    return p


def main(argv: Sequence[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except (ValueError, OSError) as e:
        # domain errors (bad cache format, unknown hyperparameters,
        # mismatched shards) and missing files are user errors, not crashes
        raise SystemExit(f"error: {e}")


if __name__ == "__main__":
    sys.exit(main())

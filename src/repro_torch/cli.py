"""Command line of the port: ``python -m repro_torch <subcommand>``.

Port of ``src/repro/cli.py``, with the subcommands of this slice's path:

  record      strategy-sample a registered kernel live on the card (or its
              plain version on the CPU) into a replayable T4 cache
  bruteforce  exhaustively record a registered kernel's valid space
  merge-cache fold recording shards into one canonical cache file
  simulate    score one strategy configuration with the methodology in
              simulation mode (paper Sec. III-B/C, Eqs. 2–3)

Flags mirror ``repro``'s flags of the same names, with one difference:
``--device`` names where the work runs (``cuda``, the default, or
``cpu``), and a live recording is labelled with the card's name. There is
no hub yet, so ``simulate`` takes its spaces from ``--cache`` files.
"""
from __future__ import annotations

import argparse
import ast
import sys
import time
from typing import Sequence

from .core import record as rec
from .core.cache import CacheFile
from .core.methodology import evaluate_strategy, make_scorer
from .core.parallel import StrategyFactory
from .core.strategies import STRATEGIES
from .kernels import KERNELS


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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro_torch",
        description="Tuning the Tuner on PyTorch/CUDA — live recording of "
                    "hand-written Hopper kernels and simulation-mode "
                    "scoring")
    sub = p.add_subparsers(dest="command", required=True)

    def add_record_args(pp, bruteforce: bool) -> None:
        pp.add_argument("--kernel", required=True, choices=sorted(KERNELS))
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
                            choices=sorted(STRATEGIES))
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
    pmc.set_defaults(fn=cmd_merge_cache)

    ps = sub.add_parser("simulate", help="score one strategy configuration "
                        "with the methodology (Sec. III-B)")
    ps.add_argument("--strategy", required=True, choices=sorted(STRATEGIES))
    ps.add_argument("--hyperparams", default=None, metavar="K=V,...",
                    help="strategy hyperparameters (default: DEFAULTS)")
    ps.add_argument("--cache", action="append", required=True,
                    metavar="PATH", help="T4 cache file; repeatable")
    ps.add_argument("--repeats", type=int, default=25,
                    help="methodology repeats per space (paper uses 25)")
    ps.add_argument("--engine", choices=("torch", "vectorized", "scalar"),
                    default="torch",
                    help="torch replays every batch through the budget-scan "
                         "kernel; vectorized and scalar are the numpy "
                         "engines. Scores are bit-identical across all three")
    ps.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where the torch engine replays (default: the card)")
    ps.add_argument("--seed", type=int, default=0)
    ps.set_defaults(fn=cmd_simulate)
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

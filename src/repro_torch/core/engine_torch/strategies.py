"""Free-running population strategies on the card (batched over runs).

Port of ``src/repro/core/engine_jax/strategies.py``. The numpy GA / PSO /
DE / random search are pure state transitions: each strategy is a
namespace of ``init``/``ask``/``tell`` functions over an explicit state, a
dict of tensors whose leading axis is the R runs (the reference's
``vmap``). ``free_run`` steps all R runs through G generations in a
Python loop (the reference's ``lax.scan``), and each generation charges
its R x P asks through one launch of the hand-written budget-scan kernel
(``replay.budget_scan``, ``csrc/budget_scan.cu``), which gathers value
and charge through ``col_of_row``, imputes misses and commits fresh
entries left to right in float64.

Statistical contract (as the reference's): this mode is *statistically*
equivalent to the numpy strategies and to the reference's ``free_run``,
not bit-identical to either. The device generator (one
``torch.Generator`` on the run's device, seeded from ``seed``) cannot
replay ``random.Random``/``np.random.Generator`` streams or jax's
threefry keys, and the reference's two algorithmic substitutions stay:

  * repair: an invalid child or decode restarts at a uniform random valid
    row instead of walking the BFS nearest-valid move tables;
  * GA ``disruptive_uniform`` crossover falls back to ``uniform``.

Changes from the reference, each forced by the library:

  * one generator stream feeds every draw of every run, where the
    reference splits a key per run. A run whose budget is spent freezes
    its state, as the reference's does, but the shared stream goes on
    advancing (the reference freezes the run's key too);
  * random search draws its per-run permutation once, in ``init``: the
    reference redraws only where its ``it`` is 0, which after the first
    generation holds only on a run that is already stopped, whose asks
    commit nothing;
  * GA parent selection draws an integer below the rank weights' sum and
    looks it up in their cumulative sums, the same distribution as the
    reference's ``categorical`` over ``log(P..1)``;
  * ``seen`` takes accepted rows only, through a scatter whose refused
    entries land in a spare last column: an accepted row is the first of
    its duplicates in a generation, so no two writes of one row disagree
    (a duplicate's refusal can never clear its first occurrence's mark).

Everything on the budget side *is* exact: generations charge through the
same kernel as replay-from-log (left-to-right float64, fresh entries
only, the pre-evaluation exhaustion check), revisits are free through a
per-run ``seen`` table, and a run freezes at the generation where the
numpy driver would have caught ``BudgetExhausted``. Pinned seeds
reproduce bit for bit against themselves on one device.

The loop never synchronises with the host: the budget, ``seen``, the
best values and the curves stay device tensors, and each output is
copied to the host once, after the loop; on the card without blocking,
behind one synchronisation.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ... import cuda
from ..strategies.base import FAILURE_FITNESS
from .replay import _NO_MAX_E, _NO_MAX_S, budget_scan
from .tables import replay_tables, space_tables

INF = float("inf")


class _Ctx:
    """What a generation's transitions read: the run's generator, sizes,
    the space's device tables and constants made once a call."""

    def __init__(self, st, dev: str, runs: int, P: int, hp: dict,
                 g: torch.Generator):
        self.st, self.dev, self.R, self.P, self.hp, self.g = (
            st, dev, runs, P, hp, g)
        self.T, self.n_valid = st.n_tunables, st.n_valid
        self.span = torch.clamp(st.x_hi, min=1.0)

    def rand(self, *shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.g, dtype=torch.float64,
                          device=self.dev)

    def randint(self, lo: int, hi: int, *shape) -> torch.Tensor:
        return torch.randint(lo, hi, shape, generator=self.g,
                             dtype=torch.int64, device=self.dev)

    def rand_rows(self, *shape) -> torch.Tensor:
        return self.randint(0, self.n_valid, *shape)

    def rows_of(self, k: torch.Tensor) -> torch.Tensor:
        """Space row of each value-index vector of ``k`` (..., T); -1 for
        an invalid config. The flat index is an int64 product summed over
        the last axis (CUDA has no int64 matmul)."""
        flat = (k.long() * self.st.strides).sum(-1, dtype=torch.int64)
        return self.st.row_of_flat[flat].long()

    def decode(self, x: torch.Tensor) -> torch.Tensor:
        """Round and clip a (R, P, T) continuous index matrix to rows;
        invalid positions restart at a uniform random valid row (the
        device stand-in for the BFS repair tables). ``torch.round`` rounds
        half to even, as ``jnp.rint``."""
        k = torch.minimum(torch.round(x).clamp(min=0.0), self.st.x_hi)
        rows = self.rows_of(k)
        rnd = self.rand_rows(*rows.shape)
        return torch.where(rows < 0, rnd, rows)

    def take(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """``x[r, idx[r, ...]]`` for every run r: rows of a (R, P, ...)
        tensor picked by a (R, K) index tensor."""
        flat = idx.reshape(self.R, -1)
        tail = x.shape[2:]
        out = torch.gather(x, 1, flat.reshape(flat.shape + (1,) * len(tail))
                           .expand(flat.shape + tail))
        return out.reshape(idx.shape + tail)


def _restart(it: torch.Tensor, period: int) -> torch.Tensor:
    it = it + 1
    return torch.where(it >= period, torch.zeros_like(it), it)


# --------------------------------------------------------------- crossovers
def _cross_uniform(a, b, c: _Ctx):
    mask = c.rand(*a.shape) < 0.5
    return torch.where(mask, b, a), torch.where(mask, a, b)


def _cross_single_point(a, b, c: _Ctx):
    T = c.T
    if T < 2:
        return a, b
    pt = c.randint(1, T, *a.shape[:-1])
    mask = torch.arange(T, device=c.dev) >= pt[..., None]
    return torch.where(mask, b, a), torch.where(mask, a, b)


def _cross_two_point(a, b, c: _Ctx):
    T = c.T
    if T < 3:
        return _cross_single_point(a, b, c)
    i = c.randint(1, T, *a.shape[:-1])
    j = c.randint(1, T - 1, *a.shape[:-1])
    j = j + (j >= i).long()  # distinct uniform pair from 1..T-1
    lo, hi = torch.minimum(i, j), torch.maximum(i, j)
    ar = torch.arange(T, device=c.dev)
    mask = (ar >= lo[..., None]) & (ar < hi[..., None])
    return torch.where(mask, b, a), torch.where(mask, a, b)


_CROSSOVERS = {
    "single_point": _cross_single_point,
    "two_point": _cross_two_point,
    "uniform": _cross_uniform,
    # device fallback: the disruptive variant's guaranteed-half swap of the
    # differing-gene set is data-dependent; plain uniform is the closest
    # shape-static operator
    "disruptive_uniform": _cross_uniform,
}


# ---------------------------------------------------------------- strategies
class _GA:
    name = "genetic_algorithm"
    defaults = {"method": "uniform", "popsize": 20, "maxiter": 100,
                "mutation_chance": 10}

    @staticmethod
    def init(c: _Ctx) -> dict:
        P = c.P
        # rank weights P..1 (best first) and their cumulative sums: an
        # integer draw below the total picks rank i with weight P - i
        cum = np.cumsum(np.arange(P, 0, -1, dtype=np.int64))
        c.rank_cum = torch.from_numpy(cum).to(c.dev)
        c.cards = torch.tensor(c.st.cards, dtype=torch.float64,
                               device=c.dev)
        c.cards_hi = c.cards.long() - 1
        return {"pop": torch.zeros((c.R, P, c.T), dtype=torch.int64,
                                   device=c.dev),
                "it": torch.zeros(c.R, dtype=torch.int64, device=c.dev)}

    @staticmethod
    def ask(state: dict, c: _Ctx) -> tuple:
        need = (state["it"] == 0)[:, None, None]
        init_pop = c.st.vidx[c.rand_rows(c.R, c.P)].long()
        pop = torch.where(need, init_pop, state["pop"])
        return c.rows_of(pop), {**state, "pop": pop}

    @staticmethod
    def tell(state: dict, rows, fitness, c: _Ctx) -> dict:
        P, T, hp = c.P, c.T, c.hp
        crossover = _CROSSOVERS[str(hp["method"])]
        p_mut = 1.0 / float(hp["mutation_chance"])
        ranked = c.take(state["pop"],
                        torch.argsort(fitness, dim=1, stable=True))
        n_pairs = max(1, P // 2)
        # rank-weighted parent selection: best gets weight P, worst 1
        draw = c.randint(0, P * (P + 1) // 2, c.R, n_pairs, 2)
        parents = torch.bucketize(draw, c.rank_cum, right=True)
        c1, c2 = crossover(c.take(ranked, parents[..., 0]),
                           c.take(ranked, parents[..., 1]), c)
        children = torch.stack([c1, c2], dim=2).reshape(
            c.R, 2 * n_pairs, T)[:, :P - 1]
        # per-gene mutation to a uniform value index of that tunable
        mut = c.rand(*children.shape) < p_mut
        draws = torch.floor(c.rand(*children.shape) * c.cards).long()
        draws = torch.minimum(draws, c.cards_hi)  # u * card may round up
        children = torch.where(mut, draws, children)
        # repair: invalid offspring restart at a random valid genome
        bad = c.rows_of(children) < 0
        rescue = c.st.vidx[c.rand_rows(c.R, P - 1)].long()
        children = torch.where(bad[..., None], rescue, children)
        new_pop = torch.cat([ranked[:, :1], children], dim=1)  # elitism
        return {"pop": new_pop, "it": _restart(state["it"],
                                               int(hp["maxiter"]))}


class _PSO:
    name = "pso"
    defaults = {"popsize": 20, "maxiter": 100, "c1": 2.0, "c2": 1.0,
                "w": 0.5}

    @staticmethod
    def init(c: _Ctx) -> dict:
        R, P, T, dev = c.R, c.P, c.T, c.dev
        zeros = torch.zeros((R, P, T), dtype=torch.float64, device=dev)
        return {"pos": zeros, "vel": zeros, "pbest": zeros,
                "pbest_f": torch.full((R, P), INF, dtype=torch.float64,
                                      device=dev),
                "gbest": torch.zeros((R, T), dtype=torch.float64,
                                     device=dev),
                "gbest_f": torch.full((R,), INF, dtype=torch.float64,
                                      device=dev),
                "it": torch.zeros(R, dtype=torch.int64, device=dev)}

    @staticmethod
    def ask(state: dict, c: _Ctx) -> tuple:
        need = state["it"] == 0
        n3 = need[:, None, None]
        pos0 = c.st.vidx[c.rand_rows(c.R, c.P)].double()
        vel0 = (c.rand(*pos0.shape) * 2.0 - 1.0) * c.span * 0.25
        pos = torch.where(n3, pos0, state["pos"])
        state = {**state,
                 "pos": pos,
                 "vel": torch.where(n3, vel0, state["vel"]),
                 "pbest": torch.where(n3, pos, state["pbest"]),
                 "pbest_f": torch.where(need[:, None], INF,
                                        state["pbest_f"]),
                 "gbest": torch.where(need[:, None], pos[:, 0],
                                      state["gbest"]),
                 "gbest_f": torch.where(need, INF, state["gbest_f"])}
        return c.decode(pos), state

    @staticmethod
    def tell(state: dict, rows, fitness, c: _Ctx) -> dict:
        hp = c.hp
        c1, c2, w = float(hp["c1"]), float(hp["c2"]), float(hp["w"])
        x = c.st.vidx[rows].double()
        better = fitness < state["pbest_f"]
        pbest = torch.where(better[..., None], x, state["pbest"])
        pbest_f = torch.where(better, fitness, state["pbest_f"])
        # sequential global-best update == first index achieving the min
        i = torch.argmin(fitness, dim=1)[:, None]
        fi = torch.gather(fitness, 1, i)[:, 0]
        gb = fi < state["gbest_f"]
        gbest = torch.where(gb[:, None], c.take(x, i)[:, 0], state["gbest"])
        gbest_f = torch.where(gb, fi, state["gbest_f"])
        pos = state["pos"]
        r1 = c.rand(*pos.shape)
        r2 = c.rand(*pos.shape)
        vel = (w * state["vel"] + c1 * r1 * (pbest - pos)
               + c2 * r2 * (gbest[:, None] - pos))
        vel = torch.minimum(torch.maximum(vel, -c.span), c.span)
        pos = torch.minimum((pos + vel).clamp(min=0.0), c.st.x_hi)
        return {"pos": pos, "vel": vel, "pbest": pbest, "pbest_f": pbest_f,
                "gbest": gbest, "gbest_f": gbest_f,
                "it": _restart(state["it"], int(hp["maxiter"]))}


class _DE:
    """DE/rand/1/bin, deferred updating (the whole-generation batch form —
    immediate updating is inherently sequential per member)."""

    name = "differential_evolution"
    defaults = {"popsize": 20, "maxiter": 100, "F": 0.8, "CR": 0.9}

    @staticmethod
    def init(c: _Ctx) -> dict:
        R, P, T, dev = c.R, c.P, c.T, c.dev
        c.eye2 = 2.0 * torch.eye(P, dtype=torch.float64, device=dev)
        zeros = torch.zeros((R, P, T), dtype=torch.float64, device=dev)
        return {"pop": zeros,
                "fit": torch.full((R, P), INF, dtype=torch.float64,
                                  device=dev),
                "trial": zeros,
                "initgen": torch.ones(R, dtype=torch.bool, device=dev),
                "it": torch.zeros(R, dtype=torch.int64, device=dev)}

    @staticmethod
    def ask(state: dict, c: _Ctx) -> tuple:
        F, CR = float(c.hp["F"]), float(c.hp["CR"])
        R, P, T = c.R, c.P, c.T
        need = state["it"] == 0
        n3 = need[:, None, None]
        pop0 = c.st.vidx[c.rand_rows(R, P)].double()
        pop = torch.where(n3, pop0, state["pop"])
        # a,b,c: distinct members != i, via argsort of uniforms with the
        # diagonal masked (uniform ordered sample without replacement)
        abc = torch.argsort(c.rand(R, P, P) + c.eye2, dim=2)[..., :3]
        a, b, cc = (c.take(pop, abc[..., k]) for k in range(3))
        mutant = torch.minimum((a + F * (b - cc)).clamp(min=0.0),
                               c.st.x_hi)
        cross = c.rand(R, P, T) < CR
        forced = c.randint(0, T, R, P)
        cross = cross | (torch.arange(T, device=c.dev) == forced[..., None])
        trial = torch.where(cross, mutant, pop)
        trial = torch.where(n3, pop, trial)  # init generation asks the pop
        state = {**state, "pop": pop, "trial": trial, "initgen": need}
        return c.decode(trial), state

    @staticmethod
    def tell(state: dict, rows, fitness, c: _Ctx) -> dict:
        sel = state["initgen"][:, None] | (fitness <= state["fit"])
        pop = torch.where(sel[..., None], state["trial"], state["pop"])
        fit = torch.where(sel, fitness, state["fit"])
        return {**state, "pop": pop, "fit": fit,
                "it": _restart(state["it"], int(c.hp["maxiter"]) + 1),
                "initgen": torch.zeros_like(state["initgen"])}


class _RandomSearch:
    """Sampling without replacement: one permutation per run, consumed
    ``popsize`` rows per generation (the numpy strategy asks the whole
    permutation at once; chunking it per generation is observably
    identical under free budgets because revisits never occur)."""

    name = "random_search"
    defaults = {"popsize": 20}

    @staticmethod
    def init(c: _Ctx) -> dict:
        if c.n_valid < c.P:
            raise ValueError(
                f"random_search: popsize {c.P} exceeds the space's "
                f"{c.n_valid} valid configs (a generation asks popsize "
                f"distinct rows of one permutation)")
        c.window = torch.arange(c.P, device=c.dev)
        perm = torch.argsort(c.rand(c.R, c.n_valid), dim=1)
        return {"perm": perm,
                "offset": torch.zeros(c.R, dtype=torch.int64,
                                      device=c.dev)}

    @staticmethod
    def ask(state: dict, c: _Ctx) -> tuple:
        idx = state["offset"][:, None] + c.window
        return torch.gather(state["perm"], 1, idx), state

    @staticmethod
    def tell(state: dict, rows, fitness, c: _Ctx) -> dict:
        # the window stops at the end of the permutation (the reference's
        # dynamic_slice clamps): the tail re-asks seen rows, which are free
        # revisits — the same no-op as the finished numpy ask
        offset = torch.clamp(state["offset"] + c.P, max=c.n_valid - c.P)
        return {**state, "offset": offset}


FREE_RUN_STRATEGIES = {s.name: s for s in (_GA, _PSO, _DE, _RandomSearch)}


def _freeze(stopped: torch.Tensor, old: dict, new: dict) -> dict:
    """Each state tensor of a stopped run keeps its old value."""
    out = {}
    for k, v in new.items():
        if v is old[k]:  # unchanged by this generation (random search's perm)
            out[k] = v
            continue
        mask = stopped.reshape((-1,) + (1,) * (v.dim() - 1))
        out[k] = torch.where(mask, old[k], v)
    return out


# ------------------------------------------------------------------ driver
# free_run calls made while a torch.profiler records (none count
# otherwise): R x the generations stepped, the run-generations whose run
# had not stopped at the generation's start, and the generations whose
# start found every run stopped
calls = 0
run_gens = 0
live_run_gens = 0
dead_gens = 0

_NO_SPAN = contextlib.nullcontext()


def _no_span(name: str):
    return _NO_SPAN


def _span(name: str):
    """A host range on the profiler's clock. Not ``record_function``:
    the profiler mirrors each of those as a device-side range, which a
    reader of the trace's device operations would take for a kernel."""
    return torch._C._profiler._RecordFunctionFast(name)


def _count(runs: int, gens: int, stopped_gens: np.ndarray) -> None:
    """Adds one traced call of ``gens`` generations to the counters;
    ``stopped_gens[r]``: the generations whose start found run r stopped.
    A run stays stopped, so every run was stopped at the start of the
    last ``stopped_gens.min()`` generations and of no other."""
    global calls, run_gens, live_run_gens, dead_gens
    calls += 1
    run_gens += runs * gens
    live_run_gens += runs * gens - int(stopped_gens.sum(dtype=np.int64))
    dead_gens += int(stopped_gens.min(initial=gens))


def _pinned_numpy(t: torch.Tensor) -> np.ndarray:
    """A numpy view of a pinned host block from PyTorch's caching host
    allocator, into which ``t`` is copied without blocking on the current
    stream: it holds ``t`` once the stream is synchronised. The block
    returns to the allocator only once the view is freed, so no later
    call writes into an array a caller holds."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
        t, non_blocking=True).numpy()


def free_run(cache, strategy: str = "genetic_algorithm", *, runs: int = 32,
             seed: int = 0, generations: "int | None" = None,
             max_seconds: "float | None" = None,
             max_evals: "int | None" = None, device=None,
             **hyperparams) -> dict:
    """Run ``runs`` independent free-running campaigns of ``strategy`` on
    ``device`` (default: the card), one budget-scan launch a generation;
    returns numpy arrays keyed like ``SearchDriver`` observables (best
    value/row, spend, fresh evals, exhaustion, per-generation spend/best
    curves of shape (runs, generations)).

    Pinned-seed deterministic on one device; statistically equivalent to
    the numpy strategies (module docstring has the exact contract).

    On the card the arrays are numpy views of pinned host blocks from
    PyTorch's caching host allocator, filled by non-blocking copies and
    reached by one synchronisation of the stream; they stay pinned while
    the caller holds them. On the CPU they may share memory with the
    call's tensors, which the call no longer uses.

    While a ``torch.profiler`` records, the call marks its phases with
    host spans (``free_run``; ``free_run.init``; one ``free_run.gen`` a
    generation around ``free_run.ask``, ``.dedup``, ``.scan``, ``.tell``
    and ``.commit``; ``free_run.to_host``), every kernel inside one of the
    leaves, and adds to the module's counters: one more launch a
    generation adds ``stopped`` to a per-run count, copied with the
    outputs. Otherwise it launches, allocates and counts nothing more."""
    tracing = torch.autograd.profiler._is_profiler_enabled
    span = _span if tracing else _no_span
    with span("free_run"):
        with span("free_run.init"):
            impl = FREE_RUN_STRATEGIES[strategy]
            unknown = set(hyperparams) - set(impl.defaults)
            if unknown:
                raise ValueError(f"{strategy}: unknown hyperparameters "
                                 f"{sorted(unknown)}")
            hp = {**impl.defaults, **hyperparams}
            dev = cuda.resolve_device(device)
            compiled = cache.space.compiled
            cols = cache.columns
            rt = replay_tables(cols, compiled, dev)
            if not compiled.n_valid:
                raise ValueError(
                    f"space {compiled.name!r} has no valid configs")
            st = space_tables(compiled, dev)
            R = int(runs)
            P = int(hp.get("popsize", 20))
            G = int(generations if generations is not None
                    else hp.get("maxiter", 100))
            mean_charge = cache.mean_eval_charge() if rt.has_miss else 0.0
            max_s = _NO_MAX_S if max_seconds is None else float(max_seconds)
            max_e = _NO_MAX_E if max_evals is None else int(max_evals)
            g = torch.Generator(device=dev)
            g.manual_seed(int(seed))
            c = _Ctx(st, dev, R, P, hp, g)
            state = impl.init(c)

            n_valid = st.n_valid
            # seen[r, row]; refused entries scatter into the spare last
            # column
            seen = torch.zeros((R, n_valid + 1), dtype=torch.uint8,
                               device=dev)
            spare = torch.full((R, P), n_valid, dtype=torch.int64,
                               device=dev)
            earlier = torch.ones((P, P), dtype=torch.bool,
                                 device=dev).tril(-1)
            spent = torch.zeros(R, dtype=torch.float64, device=dev)
            evals = torch.zeros(R, dtype=torch.int64, device=dev)
            cap_s = torch.full((R,), max_s, dtype=torch.float64, device=dev)
            cap_e = torch.full((R,), max_e, dtype=torch.int64, device=dev)
            best_v = torch.full((R,), INF, dtype=torch.float64, device=dev)
            best_r = torch.full((R,), -1, dtype=torch.int64, device=dev)
            fresh_n = torch.zeros(R, dtype=torch.int64, device=dev)
            stopped = torch.zeros(R, dtype=torch.bool, device=dev)
            curve_spent = torch.empty((R, G), dtype=torch.float64,
                                      device=dev)
            curve_best = torch.empty((R, G), dtype=torch.float64,
                                     device=dev)
            # traced calls: the generations whose start found each run
            # stopped, an int64 tensor once the first generation adds to it
            stopped_gens = 0
        for gen in range(G):
            with span("free_run.gen"):
                with span("free_run.ask"):
                    rows, state_a = impl.ask(state, c)
                    rows = rows.contiguous()
                with span("free_run.dedup"):
                    # within-generation first occurrence: P is
                    # population-sized, so the P x P pairwise compare
                    # beats any n_valid-sized scatter
                    dup = ((rows[:, :, None] == rows[:, None, :])
                           & earlier).any(dim=2)
                    fresh = ~dup & (torch.gather(seen, 1, rows) == 0)
                with span("free_run.scan"):
                    accept, _t, value, _charge, spent, evals, exh = (
                        budget_scan(rows, fresh, rt.col_of_row, rt.time_s,
                                    rt.charge_s, mean_charge, spent, evals,
                                    cap_s, cap_e))
                with span("free_run.tell"):
                    finite = torch.isfinite(value)
                    fitness = torch.where(finite, value, FAILURE_FITNESS)
                    state_b = impl.tell(state_a, rows, fitness, c)
                with span("free_run.commit"):
                    seen.scatter_(1, torch.where(accept, rows, spare), 1)
                    fresh_n += accept.sum(dim=1, dtype=torch.int64)
                    okv = torch.where(accept & finite, value, INF)
                    j = torch.argmin(okv, dim=1)[:, None]
                    vj = torch.gather(okv, 1, j)[:, 0]
                    better = vj < best_v
                    best_v = torch.where(better, vj, best_v)
                    best_r = torch.where(
                        better, torch.gather(rows, 1, j)[:, 0], best_r)
                    # once exhausted the numpy driver stops stepping the
                    # strategy; budget/seen/best are already
                    # monotone-frozen (no accepts can follow a refusal),
                    # so only the state needs the freeze
                    state = _freeze(stopped, state, state_b)
                    if tracing:
                        stopped_gens = stopped_gens + stopped
                    stopped = stopped | exh
                    curve_spent[:, gen] = spent
                    curve_best[:, gen] = best_v
        with span("free_run.to_host"):
            out = {"best_value": best_v, "best_row": best_r.to(torch.int32),
                   "spent_seconds": spent, "spent_evals": evals,
                   "fresh_evals": fresh_n, "exhausted": stopped,
                   "curve_spent": curve_spent, "curve_best": curve_best}
            if tracing:
                out["stopped_gens"] = torch.as_tensor(stopped_gens,
                                                      device=dev)
            card = dev != "cpu"
            to_host = _pinned_numpy if card else torch.Tensor.numpy
            out = {k: to_host(v) for k, v in out.items()}
            if card:  # one wait for every copy
                torch.cuda.current_stream(dev).synchronize()
            if tracing:
                _count(R, G, out.pop("stopped_gens"))
    return out

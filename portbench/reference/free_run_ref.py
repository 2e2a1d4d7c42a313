"""Plain reference of free-running tuning campaigns, run by run.

What ``repro_torch.core.engine_torch.free_run`` must produce, written
from the method and frozen with the benchmark, so that no later change
to the program can move the yardstick. R independent campaigns of one
population strategy step through G generations over a recorded space.
Each generation a run asks its popsize configs; an ask is fresh at its
first occurrence in the generation when the run has not committed it
before; fresh asks are charged against the run's budget of simulated
seconds one by one, left to right, each committing while the spend
before it is under the budget. A run that had a fresh ask refused is
exhausted: from the next generation on its strategy no longer moves.

The strategies, as the method states them:

  * GA: linear rank selection (rank k of P, best first, weighs P - k),
    uniform crossover of each pair, per-gene mutation to a uniform
    value with chance 1 / ``mutation_chance``, an invalid child replaced
    by a uniform valid config, the best member kept;
  * PSO: global-best particles on the value indices, velocity
    ``w v + c1 r1 (pbest - x) + c2 r2 (gbest - x)`` clipped to the
    span, the decoded config recorded as the personal and global best;
  * DE/rand/1/bin: three distinct others by the order of uniform keys,
    mutant ``a + F (b - c)`` clipped to the box, binomial crossover
    with one forced gene, the trial kept when no worse;
  * random search: one uniform permutation of the valid configs a run,
    popsize of them a generation.

A position is decoded by rounding half to even and clipping to the box;
a position that is no valid config takes a uniform valid one.

Only the draws come from the device: one ``torch.Generator`` seeded
with the call's seed, drawn for all R runs in the order the method
fixes (each strategy's ``draws``), so that the same numbers reach both
sides. Everything else is computed here, in NumPy and plain Python on
the host, for the sampled runs alone, each on its own. The tables come
from the recording file (``recording.py``).

The spend is accumulated in ``spend_dtype``: float64, the precision the
method states, or float32 for the benchmark's control (the nearest
precision below), which has to fail the comparison.
"""
from __future__ import annotations

import bisect
import math

import numpy as np
import torch

INF = float("inf")
FAILURE_FITNESS = 1e12  # what a strategy ranks a failed config by


class Space:
    """What a campaign reads of a recording: value indices and tables
    as NumPy arrays, a row's time and charge as Python floats."""

    def __init__(self, rec):
        self.n_valid = int(rec.n_valid)
        self.cards = [int(c) for c in rec.cards]
        self.strides = np.asarray(rec.strides, dtype=np.int64)
        self.vidx = np.asarray(rec.vidx, dtype=np.int64)       # (n, T)
        self.row_of_flat = np.asarray(rec.row_of_flat, dtype=np.int64)
        self.x_hi = np.asarray(rec.x_hi, dtype=np.float64)
        self.span = np.maximum(self.x_hi, 1.0)
        self.value = rec.time_s[rec.col_of_row].tolist()   # a row's time
        self.charge = rec.charge_s[rec.col_of_row].tolist()  # its charge

    def row(self, genes) -> int:
        """The row of one vector of value indices; -1 if no config."""
        return int(self.row_of_flat[int(np.dot(genes, self.strides))])

    def decode(self, x, fallback) -> list:
        """Rows of positions (P, T): round half to even, clip to the box;
        a position that is no config takes its ``fallback`` row."""
        k = np.minimum(np.maximum(np.round(x), 0.0), self.x_hi)
        rows = self.row_of_flat[k.astype(np.int64) @ self.strides]
        return np.where(rows >= 0, rows, fallback).tolist()


# A generation's draws, in the order the method takes them from the
# generator: (name, kind, shape per run). "row" is a uniform valid row,
# "u" a uniform float64 in [0, 1), ("int", n) a uniform integer below n.
def _ga_draws(P: int, T: int, n: int) -> list:
    pairs = max(1, P // 2)
    return [("start", "row", (P,)), ("pick", ("int", P * (P + 1) // 2),
                                     (pairs, 2)),
            ("swap", "u", (pairs, T)), ("mutate", "u", (P - 1, T)),
            ("gene", "u", (P - 1, T)), ("repair", "row", (P - 1,))]


def _pso_draws(P: int, T: int, n: int) -> list:
    return [("start", "row", (P,)), ("vel", "u", (P, T)),
            ("fallback", "row", (P,)), ("r1", "u", (P, T)),
            ("r2", "u", (P, T))]


def _de_draws(P: int, T: int, n: int) -> list:
    return [("start", "row", (P,)), ("keys", "u", (P, P)),
            ("cross", "u", (P, T)), ("forced", ("int", T), (P,)),
            ("fallback", "row", (P,))]


def _restart(it: int, period: int) -> int:
    return 0 if it + 1 >= period else it + 1


class GA:
    defaults = {"method": "uniform", "popsize": 20, "maxiter": 100,
                "mutation_chance": 10}
    draws = staticmethod(_ga_draws)

    def __init__(self, sp: Space, hp: dict, first: dict):
        if hp["method"] != "uniform":
            raise ValueError(f"crossover {hp['method']!r}: the reference "
                             f"follows the uniform one alone")
        self.sp, self.P = sp, int(hp["popsize"])
        self.maxiter = int(hp["maxiter"])
        self.p_mut = 1.0 / float(hp["mutation_chance"])
        # linear rank selection: rank k of P (best first) weighs P - k,
        # so it takes the draws below the k-th running total and above
        # the one before
        self.totals = np.cumsum(np.arange(self.P, 0, -1)).tolist()
        self.it = 0
        self.pop = None

    def ask(self, d: dict) -> list:
        if self.it == 0:
            self.pop = self.sp.vidx[d["start"]].tolist()
        return [self.sp.row(g) for g in self.pop]

    def tell(self, d: dict, rows, fitness) -> None:
        sp, P = self.sp, self.P
        ranked = [self.pop[i] for i in sorted(range(P),
                                              key=fitness.__getitem__)]
        children = []
        for (i, j), swap in zip(d["pick"].tolist(), d["swap"].tolist()):
            a = ranked[bisect.bisect_right(self.totals, i)]
            b = ranked[bisect.bisect_right(self.totals, j)]
            children.append([y if u < 0.5 else x
                             for x, y, u in zip(a, b, swap)])
            children.append([x if u < 0.5 else y
                             for x, y, u in zip(a, b, swap)])
        pop = [ranked[0]]
        for child, mut, gene, repair in zip(children, d["mutate"].tolist(),
                                            d["gene"].tolist(),
                                            d["repair"].tolist()):
            child = [min(math.floor(v * c), c - 1) if m < self.p_mut else g
                     for g, m, v, c in zip(child, mut, gene, sp.cards)]
            pop.append(child if sp.row(child) >= 0
                       else sp.vidx[repair].tolist())
        self.pop = pop
        self.it = _restart(self.it, self.maxiter)


class PSO:
    defaults = {"popsize": 20, "maxiter": 100, "c1": 2.0, "c2": 1.0,
                "w": 0.5}
    draws = staticmethod(_pso_draws)

    def __init__(self, sp: Space, hp: dict, first: dict):
        self.sp, self.maxiter = sp, int(hp["maxiter"])
        self.c1, self.c2, self.w = (float(hp["c1"]), float(hp["c2"]),
                                    float(hp["w"]))
        self.it = 0

    def ask(self, d: dict) -> list:
        sp = self.sp
        if self.it == 0:
            self.x = sp.vidx[d["start"]].astype(np.float64)
            self.v = (d["vel"] * 2.0 - 1.0) * sp.span * 0.25
            self.pbest = self.x.copy()
            self.pbest_f = np.full(len(self.x), INF)
            self.gbest, self.gbest_f = self.x[0].copy(), INF
        return sp.decode(self.x, d["fallback"])

    def tell(self, d: dict, rows, fitness) -> None:
        sp = self.sp
        at = sp.vidx[rows].astype(np.float64)     # the configs recorded
        f = np.asarray(fitness)
        better = f < self.pbest_f
        self.pbest[better], self.pbest_f[better] = at[better], f[better]
        i = int(np.argmin(f))
        if f[i] < self.gbest_f:
            self.gbest, self.gbest_f = at[i], f[i]
        v = (self.w * self.v + self.c1 * d["r1"] * (self.pbest - self.x)
             + self.c2 * d["r2"] * (self.gbest - self.x))
        self.v = np.minimum(np.maximum(v, -sp.span), sp.span)
        self.x = np.minimum(np.maximum(self.x + self.v, 0.0), sp.x_hi)
        self.it = _restart(self.it, self.maxiter)


class DE:
    """DE/rand/1/bin, the whole generation's trials judged together."""

    defaults = {"popsize": 20, "maxiter": 100, "F": 0.8, "CR": 0.9}
    draws = staticmethod(_de_draws)

    def __init__(self, sp: Space, hp: dict, first: dict):
        self.sp, self.P = sp, int(hp["popsize"])
        self.F, self.CR = float(hp["F"]), float(hp["CR"])
        self.maxiter = int(hp["maxiter"])
        self.it = 0
        self.fit = np.full(self.P, INF)

    def ask(self, d: dict) -> list:
        sp, P = self.sp, self.P
        self.first_gen = self.it == 0
        if self.first_gen:
            self.pop = sp.vidx[d["start"]].astype(np.float64)
            self.trial = self.pop.copy()
            return sp.decode(self.trial, d["fallback"])
        self.trial = self.pop.copy()
        for i in range(P):
            others = [j for j in range(P) if j != i]
            a, b, c = sorted(others, key=d["keys"][i].__getitem__)[:3]
            mutant = np.minimum(np.maximum(
                self.pop[a] + self.F * (self.pop[b] - self.pop[c]), 0.0),
                sp.x_hi)
            cross = d["cross"][i] < self.CR
            cross[d["forced"][i]] = True
            self.trial[i, cross] = mutant[cross]
        return sp.decode(self.trial, d["fallback"])

    def tell(self, d: dict, rows, fitness) -> None:
        for i in range(self.P):
            if self.first_gen or fitness[i] <= self.fit[i]:
                self.pop[i], self.fit[i] = self.trial[i], fitness[i]
        self.it = _restart(self.it, self.maxiter + 1)


class RandomSearch:
    """One permutation of the valid rows a run, popsize rows a
    generation; at the permutation's end it asks its last rows again."""

    defaults = {"popsize": 20}

    @staticmethod
    def draws(P: int, T: int, n: int) -> list:
        return []

    @staticmethod
    def first_draws(P: int, T: int, n: int) -> list:
        return [("keys", "u", (n,))]

    def __init__(self, sp: Space, hp: dict, first: dict):
        self.P, self.n = int(hp["popsize"]), sp.n_valid
        if self.n < self.P:
            raise ValueError("popsize exceeds the valid configs")
        self.perm = np.argsort(np.asarray(first["keys"]),
                               kind="stable").tolist()
        self.at = 0

    def ask(self, d: dict) -> list:
        return self.perm[self.at:self.at + self.P]

    def tell(self, d: dict, rows, fitness) -> None:
        self.at = min(self.at + self.P, self.n - self.P)


STRATEGIES = {"genetic_algorithm": GA, "pso": PSO,
              "differential_evolution": DE, "random_search": RandomSearch}


class Stream:
    """The call's draws: one generator on ``device`` seeded with the
    call's seed, each draw made for all ``runs`` runs; the rows of the
    runs in ``pick`` come back to the host."""

    def __init__(self, device: str, seed: int, runs: int, pick, n: int):
        self.g = torch.Generator(device=device)
        self.g.manual_seed(int(seed))
        self.device, self.runs, self.n = device, int(runs), int(n)
        self.pick = torch.as_tensor(np.asarray(pick), dtype=torch.int64,
                                    device=device)

    def take(self, spec: list) -> dict:
        out = {}
        for name, kind, shape in spec:
            full = (self.runs,) + tuple(shape)
            if kind == "u":
                x = torch.rand(full, generator=self.g, dtype=torch.float64,
                               device=self.device)
            else:
                hi = self.n if kind == "row" else int(kind[1])
                x = torch.randint(0, hi, full, generator=self.g,
                                  dtype=torch.int64, device=self.device)
            out[name] = x.index_select(0, self.pick).cpu().numpy()
        return out


def one_run(sp: Space, strategy, generations: int, budget: float,
            add, draws) -> dict:
    """A campaign's outputs; ``draws(gen)`` gives its draws of a
    generation; ``add`` adds a charge to the spend in its precision."""
    spent, committed, best_v, best_r = 0.0, set(), INF, -1
    stopped = False
    curve_spent, curve_best = [], []
    for gen in range(generations):
        if not stopped:
            d = draws(gen)
            rows = strategy.ask(d)
            asked, exhausted = set(), False
            for r in rows:
                fresh = r not in asked and r not in committed
                asked.add(r)
                if not fresh:
                    continue
                if spent < budget:
                    spent = add(spent, sp.charge[r])
                    committed.add(r)
                    if sp.value[r] < best_v:     # a failure's is inf
                        best_v, best_r = sp.value[r], r
                else:
                    exhausted = True
            fitness = [sp.value[r] if sp.value[r] < INF else FAILURE_FITNESS
                       for r in rows]
            strategy.tell(d, rows, fitness)
            stopped = exhausted
        curve_spent.append(spent)
        curve_best.append(best_v)
    return {"best_value": best_v, "best_row": best_r,
            "spent_seconds": spent, "spent_evals": len(committed),
            "fresh_evals": len(committed), "exhausted": stopped,
            "curve_spent": curve_spent, "curve_best": curve_best}


def _add64(spent: float, charge: float) -> float:
    return spent + charge


def _add32(spent: float, charge: float) -> float:
    return float(np.float32(spent) + np.float32(charge))


def free_run(rec, strategy: str, *, runs: int, seed: int, pick,
             generations: int, max_seconds: float, device: str,
             spend_dtype=np.float64, **hyperparams) -> dict:
    """The runs ``pick`` of a call of R = ``runs`` campaigns, NumPy
    outputs keyed like the program's (one row a picked run), with the
    picked runs' indices under ``runs``."""
    impl = STRATEGIES[strategy]
    unknown = set(hyperparams) - set(impl.defaults)
    if unknown:
        raise ValueError(f"{strategy}: unknown hyperparameters "
                         f"{sorted(unknown)}")
    hp = {**impl.defaults, **hyperparams}
    sp = Space(rec)
    P, T, n = int(hp["popsize"]), len(sp.cards), sp.n_valid
    pick = np.asarray(pick, dtype=np.int64)
    stream = Stream(device, seed, runs, pick, n)
    first = (stream.take(impl.first_draws(P, T, n))
             if hasattr(impl, "first_draws") else {})
    spec = impl.draws(P, T, n)
    per_gen = [stream.take(spec) for _ in range(generations)]
    add = _add64 if spend_dtype == np.float64 else _add32
    budget = float(spend_dtype(max_seconds))
    outs = []
    for i in range(len(pick)):
        strat = impl(sp, hp, {k: v[i] for k, v in first.items()})
        outs.append(one_run(
            sp, strat, generations, budget, add,
            lambda gen: {k: v[i] for k, v in per_gen[gen].items()}))
    out = {k: np.array([o[k] for o in outs]) for k in outs[0]}
    out["best_row"] = out["best_row"].astype(np.int32)
    out["runs"] = pick
    return out

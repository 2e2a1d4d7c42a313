"""RNG discipline rules.

The bit-parity contract (docs/architecture.md, "RNG parity contract")
requires every random draw in the simulation core to come from the run's
explicitly-seeded ``random.Random``/``np.random.Generator`` in a
deterministic order. Three ways code breaks that statically:

  * drawing from the *module-level* global RNG (``np.random.shuffle``,
    ``random.random``) — shared mutable state whose stream depends on
    whatever else ran in the process;
  * seeding an RNG from wall-clock time / OS entropy — different stream
    every run;
  * drawing inside iteration over a set — per-process hash order decides
    the draw order, so two bit-identical states diverge.

Port copy of ``src/repro/analysis/rules/rng.py``. Changed, for the port's
library: torch's global generator is module-level state like
``np.random``'s, so ``rng-module-draw`` also flags its draws
(``torch.rand``, ``randn``, ``randint``, ``randperm``, ``multinomial``,
``bernoulli``, ``normal``, ..., and the in-place samplers
``Tensor.uniform_``/``normal_``/``random_``/...) made without a
``generator=``, and ``torch.manual_seed``/``torch.seed``, which seed it
(as ``random.seed`` is flagged); ``rng-time-seed`` also reads
``.manual_seed(...)``.
"""
from __future__ import annotations

import ast

from ..core import (ERROR, Rule, call_name, dotted, enclosing, is_set_expr,
                    parent)

# np.random attributes that construct explicitly-seeded objects rather
# than drawing from the module-level global state
_NP_CONSTRUCTORS = frozenset({
    "default_rng", "Generator", "RandomState", "SeedSequence",
    "BitGenerator", "Philox", "PCG64", "PCG64DXSM", "MT19937", "SFC64",
})

# stdlib ``random`` module-level draw/seed functions (random.Random and
# the class names are constructors, fine when explicitly seeded)
_PY_MODULE_DRAWS = frozenset({
    "random", "randint", "randrange", "uniform", "choice", "choices",
    "shuffle", "sample", "seed", "getrandbits", "gauss", "normalvariate",
    "betavariate", "expovariate", "triangular", "vonmisesvariate",
    "paretovariate", "weibullvariate", "lognormvariate", "randbytes",
})

# draw methods on rng-like receivers (random.Random + np Generator)
_RNG_METHODS = frozenset(_PY_MODULE_DRAWS - {"seed"} | {
    "integers", "standard_normal", "normal", "permutation", "permuted",
    "bytes", "exponential",
})

_RNG_RECEIVERS = ("rng", "np_rng", "rnd", "rand", "random_state")

# torch functions that draw from (or seed) the global generator unless
# handed a ``generator=``
_TORCH_DRAWS = frozenset({
    "rand", "randn", "randint", "randperm", "multinomial", "bernoulli",
    "normal", "poisson", "rand_like", "randn_like", "randint_like",
})
_TORCH_SEEDS = frozenset({"manual_seed", "seed"})
# in-place Tensor samplers, global generator unless ``generator=``
_TORCH_INPLACE_DRAWS = frozenset({
    "uniform_", "normal_", "random_", "bernoulli_", "exponential_",
    "geometric_", "cauchy_", "log_normal_",
})


def _has_generator(node: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in node.keywords)

_TIME_SOURCES = frozenset({
    "time.time", "time.time_ns", "time.monotonic", "time.perf_counter",
    "os.urandom", "uuid.uuid4", "secrets.token_bytes", "secrets.randbits",
})


def _is_rng_receiver(recv: ast.AST) -> bool:
    name = dotted(recv)
    if name is None:
        return False
    last = name.rsplit(".", 1)[-1]
    return last in _RNG_RECEIVERS or last.endswith("_rng")


class ModuleLevelDraw(Rule):
    name = "rng-module-draw"
    severity = ERROR
    scope = ("core/",)
    invariant = ("core/ draws only from per-run seeded RNG objects, never "
                 "the np.random / random / torch module-level global "
                 "state")
    oracle = ("trace fixtures + frozen legacy loops "
              "(tests/test_protocol.py) and the bench score checksum")

    def visit_Call(self, ctx, node):
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _TORCH_INPLACE_DRAWS \
                and not _has_generator(node):
            yield self.finding(
                ctx, node,
                f"in-place draw .{node.func.attr}() without generator= "
                f"uses torch's global generator; pass the run's "
                f"torch.Generator")
            return
        name = call_name(node)
        if name is None:
            return
        parts = name.split(".")
        if parts[0] == "torch" and len(parts) == 2 \
                and (parts[1] in _TORCH_SEEDS
                     or (parts[1] in _TORCH_DRAWS
                         and not _has_generator(node))):
            yield self.finding(
                ctx, node,
                f"module-level draw {name}() uses torch's global "
                f"generator; draw from the run's torch.Generator "
                f"(generator=) instead")
        elif parts[0] in ("np", "numpy") and len(parts) >= 3 \
                and parts[1] == "random" \
                and parts[2] not in _NP_CONSTRUCTORS:
            yield self.finding(
                ctx, node,
                f"module-level draw {name}() uses numpy's global RNG; "
                f"draw from the run's np.random.Generator instead")
        elif parts[0] == "random" and len(parts) == 2 \
                and parts[1] in _PY_MODULE_DRAWS:
            yield self.finding(
                ctx, node,
                f"module-level draw {name}() uses the shared global RNG; "
                f"draw from the run's random.Random instance instead")


class TimeSeededRng(Rule):
    name = "rng-time-seed"
    severity = ERROR
    scope = ()
    invariant = ("RNGs are seeded from explicit integers derived from "
                 "(seed, space, repeat), never wall clock or OS entropy")
    oracle = ("bit-identical parallel campaigns "
              "(tests/test_parallel.py determinism suite)")

    _CONSTRUCTORS = ("random.Random", "np.random.default_rng",
                     "numpy.random.default_rng", "np.random.RandomState",
                     "numpy.random.RandomState")

    def visit_Call(self, ctx, node):
        name = call_name(node)
        if name is None:
            return
        is_ctor = name in self._CONSTRUCTORS
        is_seed = name.endswith((".seed", ".manual_seed")) or name in (
            "np.random.PRNGKey", "jax.random.PRNGKey")
        if is_ctor and not node.args and not node.keywords:
            yield self.finding(
                ctx, node,
                f"{name}() without a seed draws entropy from the OS — "
                f"every run gets a different stream")
            return
        if not (is_ctor or is_seed):
            return
        for arg in ast.walk(node):
            if isinstance(arg, ast.Call) \
                    and call_name(arg) in _TIME_SOURCES:
                yield self.finding(
                    ctx, node,
                    f"{name}(...) is seeded from {call_name(arg)}() — "
                    f"time/entropy-seeded RNG cannot replay")
                return


class DrawInSetIteration(Rule):
    name = "rng-set-iteration"
    severity = ERROR
    scope = ("core/",)
    invariant = ("RNG draw order never depends on set/dict hash order: no "
                 "draws inside iteration over a set")
    oracle = ("cross-process bit-parity (PYTHONHASHSEED varies per "
              "worker; tests/test_parallel.py)")

    def visit_Call(self, ctx, node):
        if not isinstance(node.func, ast.Attribute):
            return
        if node.func.attr not in _RNG_METHODS \
                or not _is_rng_receiver(node.func.value):
            return
        loop = enclosing(node, ast.For, ast.comprehension)
        # comprehension generators aren't parent-linked the same way; walk
        # For loops here and comprehensions below
        while loop is not None:
            if isinstance(loop, ast.For) and is_set_expr(loop.iter):
                yield self.finding(
                    ctx, node,
                    "RNG draw inside iteration over a set — draw order "
                    "follows hash order and differs between processes; "
                    "iterate a sorted() or list-ordered view")
                return
            loop = enclosing(loop, ast.For)

    def visit_comprehension(self, ctx, node):
        if not is_set_expr(node.iter):
            return
        comp = parent(node)
        if comp is None:
            return
        for sub in ast.walk(comp):
            if isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr in _RNG_METHODS \
                    and _is_rng_receiver(sub.func.value):
                yield self.finding(
                    ctx, sub,
                    "RNG draw inside a comprehension over a set — draw "
                    "order follows hash order and differs between "
                    "processes; iterate a sorted() view")
                return

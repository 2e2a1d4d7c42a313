"""Random search — the methodology's baseline strategy (paper Sec. III-B).

Port copy of ``src/repro/core/strategies/random_search.py``
and kept as its own copy: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import random

from ..driver import SearchState
from ..searchspace import SearchSpace
from ..space import RowBatch
from .base import Strategy


class _RandomSearchState(SearchState):
    def __init__(self, space: SearchSpace, rng: random.Random):
        super().__init__(space, rng)
        self.asked = False


def _rng_permutation(n: int, rng: random.Random) -> list:
    """Fisher–Yates permutation of ``range(n)`` drawing the *exact*
    ``getrandbits`` stream of ``rng.shuffle(list(range(n)))``.

    ``random.shuffle`` pays a ``_randbelow`` method call (bit_length +
    rejection loop behind a function frame) per element; at campaign scale
    the permutation draw is the whole cost of a random-search ask, and in
    the device-fused path it is the *floor* of the end-to-end wall. This
    inlines the rejection sampling and hoists ``bit_length`` out of the
    loop by walking bands of constant ``k = (i+1).bit_length()`` — ~3x
    less per-draw overhead, bit-identical permutations
    (tests/test_strategies.py pins the stream equivalence).
    """
    order = list(range(n))
    grb = rng.getrandbits
    m = n  # draws _randbelow(m) for m = n .. 2, exactly like shuffle
    while m > 1:
        k = m.bit_length()
        band_lo = max(1 << (k - 1), 2)
        while m >= band_lo:
            r = grb(k)
            while r >= m:
                r = grb(k)
            i = m - 1
            order[i], order[r] = order[r], order[i]
            m -= 1
    return order


class RandomSearch(Strategy):
    name = "random_search"
    DEFAULTS: dict = {}

    def init_state(self, space: SearchSpace,
                   rng: random.Random) -> _RandomSearchState:
        return _RandomSearchState(space, rng)

    def ask(self, state: _RandomSearchState):
        # Sample *without replacement* over valid configs (Kernel Tuner
        # semantics: the tuner cache makes revisits free, so random search
        # is effectively a random permutation of the space). The whole
        # permutation is ONE ask — index-native: shuffling the row range
        # draws from rng exactly like shuffling the config list (Fisher-
        # Yates only reads the length), and the RowBatch resolves as one
        # columnar row gather, with budget exhaustion stopping at exactly
        # the same config as the scalar loop.
        if state.asked:
            return None  # the permutation survived the budget: we are done
        state.asked = True
        cs = state.space.compiled
        return RowBatch(cs, _rng_permutation(cs.n_valid, state.rng))

    def tell(self, state: _RandomSearchState, observations) -> None:
        pass  # best-so-far tracking lives in the runner's trace

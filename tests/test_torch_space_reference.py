"""The port's frozen scalar space (``repro_torch.core.space.reference``).

Holds the port's ``ReferenceSearchSpace`` against the reference's copy,
element for element and rng draw for rng draw, and pins the port's
compiled ``SearchSpace`` against the port's copy with the seeds and the
checks of ``tests/test_space_compiled.py``.
"""
import random

import numpy as np
import pytest

from repro.core.space.reference import ReferenceSearchSpace as RefSpace
from repro.core.tunable import Constraint as RefConstraint
from repro.core.tunable import Tunable as RefTunable
from repro_torch.core.searchspace import SearchSpace
from repro_torch.core.space.reference import ReferenceSearchSpace
from repro_torch.core.tunable import Constraint, Tunable, tunables_from_dict

_CONSTRAINTS = (
    None,
    ("sum%3", lambda d: sum(v if isinstance(v, int) else 0
                            for v in d.values()) % 3 != 0),
    ("product", lambda d: _int_product(d) <= 64),
    ("never", lambda d: False),
)


def _int_product(d):
    out = 1
    for v in d.values():
        if isinstance(v, int):
            out *= max(v, 1)
    return out


def _spec(seed: int):
    """Random tunables and a constraint, as ``test_space_compiled`` draws
    them: [(name, values)], (constraint name, fn) or None."""
    rng = random.Random(seed)
    n_t = 2 + seed % 3
    tun = []
    for i in range(n_t):
        card = 2 + rng.randrange(6)
        if i == n_t - 1 and seed % 4 == 0:
            values = tuple("abcdefgh"[:card])
        else:
            base = rng.randrange(4)
            values = tuple(base + 2 * k for k in range(card))
        tun.append((f"t{i}", values))
    return tun, _CONSTRAINTS[seed % len(_CONSTRAINTS)]


def _build(seed: int, space_cls, tunable_cls, constraint_cls):
    tun, cons = _spec(seed)
    cons = (constraint_cls(cons[1], cons[0]),) if cons else ()
    return space_cls([tunable_cls(n, v) for n, v in tun], cons,
                     name=f"sweep{seed}")


def _port_ref(seed):
    return _build(seed, ReferenceSearchSpace, Tunable, Constraint)


def _pairs(seed):
    """(candidate, oracle) pairs: the port's frozen copy against the
    reference's, and the port's compiled space against the port's copy."""
    return [(_port_ref(seed), _build(seed, RefSpace, RefTunable,
                                     RefConstraint)),
            (_build(seed, SearchSpace, Tunable, Constraint), _port_ref(seed))]


def _check_enumeration(s, r, seed):
    assert s.cartesian_size == r.cartesian_size
    assert s.valid_configs == r.valid_configs
    assert s.size == r.size
    for c in r.valid_configs:
        assert s.is_valid(c)
        assert s.neighbors(c) == r.neighbors(c)
        assert s.neighbors(c, strictly_adjacent=True) == \
            r.neighbors(c, strictly_adjacent=True)
        assert s.config_id(c) == r.config_id(c)
    probe = random.Random(seed)
    for _ in range(20):
        c = tuple(t.values[probe.randrange(t.cardinality)]
                  for t in s.tunables)
        assert s.is_valid(c) == r.is_valid(c)
    assert not s.is_valid(("not-a-value",) * len(s.tunables))


def _check_sampling(s, r, seed):
    if r.size == 0:
        return
    rs, rr = random.Random(seed), random.Random(seed)
    for _ in range(10):
        assert s.random_config(rs) == r.random_config(rr)
    assert rs.getstate() == rr.getstate()
    probe = random.Random(~seed & 0xFFFF)
    for _ in range(15):
        c = tuple(t.values[probe.randrange(t.cardinality)]
                  for t in s.tunables)
        assert s.nearest_valid(c, rs) == r.nearest_valid(c, rr)
        assert rs.getstate() == rr.getstate()
    x = np.random.default_rng(seed).uniform(
        -1.0, max(t.cardinality for t in s.tunables),
        size=(12, len(s.tunables)))
    assert s.decode_batch(x, rs) == r.decode_batch(x, rr)
    assert rs.getstate() == rr.getstate()


@pytest.mark.parametrize("seed", range(0, 24))
@pytest.mark.parametrize("pair", ["copy-vs-reference", "compiled-vs-copy"])
def test_enumeration_and_neighbors_match(seed, pair):
    s, r = _pairs(seed)[pair == "compiled-vs-copy"]
    _check_enumeration(s, r, seed)


@pytest.mark.parametrize("seed", range(0, 24))
@pytest.mark.parametrize("pair", ["copy-vs-reference", "compiled-vs-copy"])
def test_sampling_and_repair_draw_parity(seed, pair):
    s, r = _pairs(seed)[pair == "compiled-vs-copy"]
    _check_sampling(s, r, seed)


@pytest.mark.parametrize("pair", ["copy-vs-reference", "compiled-vs-copy"])
def test_indices_bounds_and_out_of_vocab_repair(pair):
    s, r = _pairs(7)[pair == "compiled-vs-copy"]
    for c in r.valid_configs:
        assert np.array_equal(s.to_indices(c), r.to_indices(c))
        assert s.from_indices(r.to_indices(c)) == c
    assert s.from_indices([99.0] * len(s.tunables)) == \
        r.from_indices([99.0] * len(r.tunables))
    assert s.bounds == r.bounds
    s, r = _pairs(5)[pair == "compiled-vs-copy"]
    oov = ("?!",) + tuple(t.values[0] for t in s.tunables[1:])
    for seed in range(10):
        rs, rr = random.Random(seed), random.Random(seed)
        assert s.nearest_valid(oov, rs) == r.nearest_valid(oov, rr)
        assert rs.getstate() == rr.getstate()


def test_bfs_exhaustion_falls_back_to_the_same_random_draws():
    """Only the all-ones corner of a 6-bit cube is valid: from all zeros
    the depth-3 search exhausts and both draw a random config."""
    spaces = []
    for space_cls, tun_fn, cons_cls in (
            (ReferenceSearchSpace, tunables_from_dict, Constraint),
            (SearchSpace, tunables_from_dict, Constraint)):
        tun = tun_fn({f"b{i}": (0, 1) for i in range(6)})
        spaces.append(space_cls(tun, (cons_cls(
            lambda d: all(v == 1 for v in d.values()), "all ones"),),
            name="far"))
    ref = RefSpace([RefTunable(f"b{i}", (0, 1)) for i in range(6)],
                   (RefConstraint(lambda d: all(v == 1 for v in d.values()),
                                  "all ones"),), name="far")
    for seed in range(25):
        rngs = [random.Random(seed) for _ in range(3)]
        got = [sp.nearest_valid((0,) * 6, g)
               for sp, g in zip([*spaces, ref], rngs)]
        assert got == [(1,) * 6] * 3
        assert rngs[0].getstate() == rngs[1].getstate() == \
            rngs[2].getstate() != random.Random(seed).getstate()


def test_empty_space_raises_as_the_reference():
    tun = tunables_from_dict({"a": (1, 2), "b": (3, 4)})
    s = ReferenceSearchSpace(tun, (Constraint(lambda d: False, "never"),))
    assert s.size == 0 and s.valid_configs == []
    with pytest.raises(ValueError, match="no valid configs"):
        s.random_config(random.Random(0))

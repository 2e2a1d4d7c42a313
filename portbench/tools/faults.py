"""Faults planted under the timed path, to show that the check fails them.

Each is a context manager that breaks the port's ``free_run`` from
inside while it is active (the reference is never touched):

  * ``state_unchanged``: the strategy's ``tell`` returns its state as it
    got it, so no run ever moves on;
  * ``half_left_out``: the budget scan sees the second half of the runs'
    asks as not fresh, so half the batch is never charged;
  * ``answer_altered``: the budget scan's spend of every run comes out
    one float64 step high, where it is produced, so that whichever runs
    the check samples hold the altered answer.

One card only: no exchange between cards exists to leave out.
"""
from __future__ import annotations

import contextlib
from unittest import mock


@contextlib.contextmanager
def state_unchanged(strategy: str):
    from repro_torch.core.engine_torch import strategies as frs
    impl = frs.FREE_RUN_STRATEGIES[strategy]
    with mock.patch.object(impl, "tell",
                           staticmethod(lambda state, rows, fit, c: state)):
        yield


def _wrap_scan(before=None, after=None):
    """Patch the budget scan that ``free_run`` calls: ``before`` changes
    its (rows, fresh), ``after`` its outputs."""
    from repro_torch.core.engine_torch import strategies as frs
    real = frs.budget_scan

    def scan(rows, fresh, *args):
        if before is not None:
            rows, fresh = before(rows, fresh)
        out = real(rows, fresh, *args)
        return out if after is None else after(out)

    return mock.patch.object(frs, "budget_scan", scan)


@contextlib.contextmanager
def half_left_out(strategy: str):
    def before(rows, fresh):
        fresh = fresh.clone()
        fresh[fresh.shape[0] // 2:] = False
        return rows, fresh

    with _wrap_scan(before=before):
        yield


@contextlib.contextmanager
def answer_altered(strategy: str):
    import torch

    def after(out):
        accept, t_after, value, charge, spent, evals, exh = out
        spent = torch.nextafter(spent, torch.full_like(spent, float("inf")))
        return accept, t_after, value, charge, spent, evals, exh

    with _wrap_scan(after=after):
        yield


FAULTS = {"state_unchanged": state_unchanged,
          "half_left_out": half_left_out,
          "answer_altered": answer_altered}

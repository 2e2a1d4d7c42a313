"""Deprecation warning categories of the port's retired API surfaces.

Port of ``src/repro/deprecations.py``: the same pattern, with the port's
own classes. A retired surface keeps a thin delegating shim that emits a
dedicated ``DeprecationWarning`` subclass, defined in this dependency-free
module so that a warning filter can name the category without importing
the shim. Only ``ServingMovedWarning`` is here: the reference's
``HubDeprecationWarning`` guards ``core.dataset``, which the port does not
have yet (ROADMAP Queue 1).
"""
from __future__ import annotations


class ServingMovedWarning(DeprecationWarning):
    """``repro_torch.serving`` (LLM token serving) moved to
    ``repro_torch.inference``, as ``repro.serving`` moved to
    ``repro.inference`` in the reference."""

"""Deprecation warning categories of the port's retired API surfaces.

Port of ``src/repro/deprecations.py``: the same pattern, with the port's
own classes. A retired surface keeps a thin delegating shim that emits a
dedicated ``DeprecationWarning`` subclass, defined in this dependency-free
module so that a warning filter can name the category without importing
the shim. ``pytest.ini`` escalates only ``repro``'s classes, so a test of
a port's shim asserts its warning with ``pytest.warns``.
"""
from __future__ import annotations


class HubDeprecationWarning(DeprecationWarning):
    """The ``repro_torch.core.dataset`` free functions (``build_hub`` /
    ``load_hub`` / ``train_test_caches``) moved to ``repro_torch.hub``
    (storage layer) and the ``repro_torch.api.Hub`` facade, as the
    reference's moved to ``repro.hub``."""


class ServingMovedWarning(DeprecationWarning):
    """``repro_torch.serving`` (LLM token serving) moved to
    ``repro_torch.inference``, as ``repro.serving`` moved to
    ``repro.inference`` in the reference."""

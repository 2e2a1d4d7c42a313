"""Deprecated shim — the benchmark-hub dataset moved to ``repro_torch.hub``.

Port of ``src/repro/core/dataset.py``. The storage layer lives in
``repro_torch.hub.storage`` and the user-facing facade is
``repro_torch.api.Hub``; this module keeps the historical free-function
surface alive behind the port's ``HubDeprecationWarning``.

Loading verifies the manifest's sha256 checksums and raises
``repro_torch.hub.HubError`` on a missing/corrupt hub instead of silently
rebuilding (pass ``verify=False`` to skip digests). ``build_hub`` records
the framework kernels' smoke shapes live on the card (the port's
``hub.storage.build_hub`` takes ``device="cpu"`` for the CPU; this shim
keeps the reference's signature). The reference's ``main`` (its
``python -m repro.core.dataset build|info``) is left out: the ``hub``
verb of ``python -m repro_torch`` does the same.

Build:  python -m repro_torch hub build [--root hub]
"""
from __future__ import annotations

import warnings

from ..deprecations import HubDeprecationWarning
from ..hub import storage as _storage
from ..hub.storage import (DEFAULT_ROOT, HUB_VERSION, HubError,  # noqa: F401
                           _sha256, brute_force, t1_descriptor)


def _warn(name: str) -> None:
    warnings.warn(
        f"repro_torch.core.dataset.{name} is deprecated; use "
        f"repro_torch.hub.{name} (or the repro_torch.api.Hub facade)",
        HubDeprecationWarning, stacklevel=3)


def build_hub(root: str = DEFAULT_ROOT, progress=print) -> dict:
    _warn("build_hub")
    return _storage.build_hub(root, progress)


def load_hub(root: str = DEFAULT_ROOT, kernels=None, devices=None,
             verify: bool = True) -> dict:
    _warn("load_hub")
    return _storage.load_hub(root, kernels, devices, verify=verify)


def train_test_caches(root: str = DEFAULT_ROOT, verify: bool = True) -> tuple:
    _warn("train_test_caches")
    return _storage.train_test_caches(root, verify=verify)

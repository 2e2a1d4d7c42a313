"""Deprecated shim — LLM token serving moved to ``repro_torch.inference``.

Port of ``src/repro/serving/__init__.py``: importing through here keeps
working behind the port's own ``ServingMovedWarning``.
"""
from __future__ import annotations

import warnings

from ..deprecations import ServingMovedWarning

warnings.warn(
    "repro_torch.serving moved to repro_torch.inference (LLM token "
    "serving)", ServingMovedWarning, stacklevel=2)

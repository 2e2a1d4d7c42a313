"""Deprecated shim — see ``repro_torch.inference.engine`` (port of
``src/repro/serving/engine.py``)."""
from __future__ import annotations

from ..inference.engine import (Request, ServingEngine,  # noqa: F401
                                make_decode_fn)

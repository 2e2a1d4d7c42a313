"""Tuning-as-a-service over the recorded hub.

Port of ``src/repro/service/__init__.py``, with the same exports.
``ConfigHub`` answers "best config for (kernel, problem shape, device)" in
microseconds from the FAIR dataset: exact hits from a precomputed
in-memory index, shape misses by nearest-problem transfer with provenance
and confidence, cold keys (optionally) by a single-flight journaled
warm-start campaign — live on the card for a key on the card's label.

    from repro_torch.service import ConfigHub

    hub = ConfigHub()                       # reads hub/manifest.json once
    r = hub.lookup("gemm", {"m": 4096, "n": 4096, "k": 4096}, "tpu_v5e")
    r.status, r.best_config, r.confidence   # 'exact', {...}, 1.0
"""
from .hub import ConfigHub, LookupResult, notify_cache_merged
from .transfer import shape_distance, transfer_confidence
from .warmstart import WarmStartFlight, WarmStartManager

__all__ = ["ConfigHub", "LookupResult", "notify_cache_merged",
           "shape_distance", "transfer_confidence", "WarmStartFlight",
           "WarmStartManager"]

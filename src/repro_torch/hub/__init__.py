"""Benchmark hub: FAIR on-disk storage for recorded tuning data.

Port of ``src/repro/hub/__init__.py``, with the same exports.
``repro_torch.hub.storage`` is the data layer (build / load / verify /
register); ``repro_torch.api.Hub`` is the user-facing facade;
``repro_torch.service`` serves lookups over it. ``python -m repro_torch
hub build|info|verify|stats`` is the CLI entry point.
"""
from .storage import (DEFAULT_ROOT, HUB_VERSION, HubError, build_hub,
                      entry_key, hub_default_problem, load_cache, load_hub,
                      problem_key, read_manifest,
                      record_framework_smoke, register_cache, split_key,
                      train_test_caches, verify_manifest, write_manifest)

__all__ = [
    "DEFAULT_ROOT", "HUB_VERSION", "HubError", "build_hub", "entry_key",
    "hub_default_problem", "load_cache", "load_hub", "problem_key",
    "read_manifest", "record_framework_smoke", "register_cache",
    "split_key", "train_test_caches",
    "verify_manifest", "write_manifest",
]

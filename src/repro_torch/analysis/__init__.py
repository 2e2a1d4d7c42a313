"""parity-lint: static analysis for the port's determinism contracts.

Port of ``src/repro/analysis/`` module for module. The rule names,
severities, suppression comment, baseline format and reports are the
reference's; four rules are retargeted at the port's device and library
(each module's docstring says how): ``rng`` counts torch's global
generator as module-level state, ``pickle_safety`` knows the port's
mirror caches (``_device*``, ``_torch*``), and ``f64`` and
``device_sync`` scope ``core/engine_torch/`` and read torch's calls.

The simulation mode is only trustworthy because replayed runs are
bit-identical to recorded ones, and the whole house style enforces that
with *runtime* oracles — trace fixtures, engine-parity suites, the bench
score checksum. This package encodes the same contracts as AST rules so a
hazard is caught when it is written, not when a fixture happens to
exercise it:

  * RNG discipline (``rules/rng.py``) — no module-level/time-seeded
    draws in core/, no draws ordered by set iteration;
  * pickle safety (``rules/pickle_safety.py``) — device/columnar mirror
    caches are dropped from pickles; SearchStates stay host-only;
  * f64 budget discipline (``rules/f64.py``) — no parallel scans, no
    float32, explicit reduction dtypes in ``core/engine_torch/``;
  * device-sync discipline (``rules/device_sync.py``) — no per-iteration
    device→host conversions in ``core/engine_torch/`` loops;
  * ask/tell conformance (``rules/protocol.py``) — strategies never call
    the runner; states don't retain runtime across snapshots;
  * ordering (``rules/ordering.py``) — sorted directory enumeration, no
    set-ordered iteration in core/.

Entry points: ``python -m repro_torch lint`` (the gate),
``lint_paths`` (programmatic), ``run_source`` (fixture tests). Deliberate
findings live in the package's checked-in baseline
(``analysis/parity-lint-baseline.json``); per-line escapes use
``# parity-lint: disable=<rule>`` and unused escapes are themselves
findings. ``python -m repro_torch lint --list-rules`` prints the rule
catalogue (docs/static-analysis.md is the reference's).
"""
from __future__ import annotations

from .core import (ERROR, SYNTAX_ERROR, UNUSED_SUPPRESSION, WARNING,
                   Finding, LintResult, Rule, lint_paths, lint_source,
                   run_source)

__all__ = ["Finding", "LintResult", "Rule", "lint_paths", "lint_source",
           "run_source", "default_rules", "ERROR", "WARNING",
           "SYNTAX_ERROR", "UNUSED_SUPPRESSION"]


def default_rules() -> list[Rule]:
    """Fresh instances of every registered rule."""
    from .rules import ALL_RULES
    return [cls() for cls in ALL_RULES]

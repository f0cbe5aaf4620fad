"""The port's static analysis: ``python -m jepsen_tpu_torch.lint [paths]``.

Two passes, the port's counterparts of the reference's
``jepsen_tpu/lint`` passes that guard the kernels:

- **budget** (:mod:`.budget`) — every kernel launch rides a path capped
  by the per-dispatch row limit (``budget-direct-dispatch``) and every
  kernel checker carries such a cap (``budget-missing-cap``).
- **kernel-audit** (:mod:`.kernel_audit`) — the kernel contracts: ptxas
  budgets against ``// jt: ptxas(...)`` bounds in the CUDA sources
  (``kernel-resources``), per-row footprints against the pricing of the
  dispatch caps (``kernel-budget``; its measurement runs on the card),
  knob → cache-key completeness (``kernel-cache-key``), no device sync
  before a launch (``kernel-host-sync``), and a registry entry for every
  entry point (``kernel-coverage``).

The AST passes use the stdlib only: linting ``ops/`` never imports torch.
A run fails on any finding not in the committed baseline
(``jepsen_tpu_torch/lint/baseline.json``); ``# jt: allow[rule-id]``
suppresses one line.  The reference's other passes (trace safety, lock
discipline, concurrency, obs hygiene, protocol, contracts, env vars),
``--changed`` and SARIF are not ported yet.
"""

from __future__ import annotations

from .core import (DEFAULT_BASELINE, Finding, LintResult,  # noqa: F401
                   Pass, Project, SourceFile, all_passes, all_rules,
                   lint_paths, load_baseline, make_baseline, write_baseline)

__all__ = [
    "DEFAULT_BASELINE", "Finding", "LintResult", "Pass", "Project",
    "SourceFile", "all_passes", "all_rules", "lint_paths",
    "load_baseline", "make_baseline", "write_baseline",
]

"""``repro_torch.lint`` — static analysis for the port (``repro.lint``'s
counterpart, DESIGN.md §10).

Two layers:

* **AST rules** (:mod:`repro_torch.lint.rules`, RL0xx) — stdlib-only
  source checks for aggregation-dispatch bypasses, GQA K/V repeats,
  host reads inside a captured CUDA graph step, unhashable specs and
  wall-clock reads outside the obs layer.
* **Auditor** (:mod:`repro_torch.lint.auditor`, RL2xx) — drives the
  port's own entry points on a device (the card unless ``"cpu"`` is
  named) and checks wire shapes and dtypes, the guards, the
  coordinatewise gate, the cache round-trip and capture stability.

Importing this package imports neither torch nor anything of ``repro``:
the auditor is pulled in lazily, so the AST layer runs where torch is
absent. Front door: ``python -m repro_torch.lint``.
"""
from .catalog import (ALL_IDS, AST_RULES, AUDIT_CHECKS, NOT_PORTED, RuleInfo,
                      info)
from .engine import (default_paths, iter_py_files, lint_file, lint_paths,
                     lint_source)
from .findings import AuditResult, Finding, Report
from .hashguard import UnhashableFieldError, check_hashable_fields
from .rules import RULES, rule_ids

__all__ = [
    "ALL_IDS", "AST_RULES", "AUDIT_CHECKS", "NOT_PORTED", "RuleInfo", "info",
    "default_paths", "iter_py_files", "lint_file", "lint_paths",
    "lint_source",
    "AuditResult", "Finding", "Report",
    "UnhashableFieldError", "check_hashable_fields",
    "RULES", "rule_ids",
    "run_audit",
]


def run_audit(*args, **kwargs):
    """Lazy proxy for :func:`repro_torch.lint.auditor.run_audit` (imports
    torch)."""
    from .auditor import run_audit as _run
    return _run(*args, **kwargs)

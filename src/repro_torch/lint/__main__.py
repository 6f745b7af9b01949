"""The port's lint: AST rules + auditor (``scripts/reprolint.py``'s
counterpart, DESIGN.md §10).

Usage (from the repository root, with ``src`` on ``PYTHONPATH``):
    python -m repro_torch.lint [paths...]   # default: the port's tree
    python -m repro_torch.lint --audit --device cpu
    python -m repro_torch.lint --format json --out lint.json
    python -m repro_torch.lint some/dir --warn-only

The default paths are ``src/repro_torch``, ``tests/test_torch_*.py`` and
``chip_smoke.py``. Paths given on the command line are taken from the
working directory. Exit status: 1 if any error finding not covered by a
waiver (``# reprolint-torch: disable=RLxxx <why>``) or any audit failure,
0 otherwise. ``--warn-only`` downgrades findings to warnings (exit 0
unless the audit fails), printing the count. ``--audit`` runs the RL2xx
auditor on ``--device`` (default: the card; it imports torch).
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint (default: the port's "
                         "package, tests and chip_smoke.py)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--out", default=None,
                    help="also write the JSON report to this file")
    ap.add_argument("--audit", action="store_true",
                    help="run the RL2xx auditor (imports torch)")
    ap.add_argument("--device", default=None,
                    help="the auditor's device (default: the card)")
    ap.add_argument("--warn-only", action="store_true",
                    help="downgrade findings to warnings (exit 0)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    from . import (AST_RULES, AUDIT_CHECKS, NOT_PORTED, Report,
                   default_paths, lint_paths)

    if args.list_rules:
        for r in AST_RULES + AUDIT_CHECKS:
            print(f"{r.id}  {r.name:28s} {r.established}")
        for r in NOT_PORTED:
            print(f"{r.id}  {r.name:28s} not ported: kernels are CUDA C++")
        return 0

    paths = ([os.path.abspath(p) for p in args.paths] if args.paths
             else default_paths(ROOT))
    severity = "warning" if args.warn_only else "error"
    findings = lint_paths(paths, ROOT, severity=severity)

    audit = []
    if args.audit:
        from .auditor import run_audit

        audit = run_audit(args.device)

    shown = [os.path.relpath(p, ROOT).replace(os.sep, "/") for p in paths]
    report = Report(findings=findings, audit=audit)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(report.to_json(shown))
    if args.format == "json":
        print(report.to_json(shown))
    else:
        print(report.render_text())

    if report.errors or report.audit_failures:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

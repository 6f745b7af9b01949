"""Layer-1 runner: file walking, waiver parsing, rule dispatch
(``repro.lint.engine``'s port).

Waiver syntax (RL000): a finding on line L is waived by a comment on
line L or L-1 of the form::

    # reprolint-torch: disable=RL001 oracle: the plain median under test

The reason after the rule list is mandatory; a bare ``disable=RL001``
produces an RL000 finding instead of a waiver, and a waiver that matches
no finding is a stale RL000 finding. The tag is the port's own:
``repro``'s lint reads ``reprolint:`` and this one ``reprolint-torch:``,
so neither takes the other's waivers for its own (nor calls them stale).

Unlike ``repro``'s walker, directories named ``build`` or ``dist`` are
skipped only when they are not Python packages: ``repro_torch.dist`` is
library code and is linted.

This layer is stdlib-only so it runs where torch is not installed.
"""
from __future__ import annotations

import ast
import glob
import io
import os
import re
import tokenize
from typing import Iterable, List, Optional, Sequence

from .findings import Finding
from .rules import RULES, Rule

__all__ = ["lint_source", "lint_file", "lint_paths", "iter_py_files",
           "default_paths"]

_TAG = "reprolint-torch"

_WAIVER_RE = re.compile(
    r"#\s*reprolint-torch:\s*disable=([A-Z]{2}\d{3}(?:\s*,\s*[A-Z]{2}\d{3})*)"
    r"\s*(.*)")

_SKIP_DIRS = frozenset((".git", "__pycache__", ".pytest_cache",
                        "node_modules", ".eggs"))
# packaging outputs: skipped unless the directory is a Python package
_SKIP_UNLESS_PACKAGE = frozenset(("build", "dist"))


def _waivers(src: str) -> dict:
    """line -> (set of rule ids, reason).

    Scans real COMMENT tokens (not strings/docstrings), so documenting
    the waiver syntax in prose does not register a waiver.
    """
    out = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(src).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _WAIVER_RE.search(tok.string)
            if m:
                ids = {s.strip() for s in m.group(1).split(",")}
                out[tok.start[0]] = (ids, m.group(2).strip())
    except tokenize.TokenError:
        pass  # unparseable file -> handled by the ast.parse error path
    return out


def lint_source(src: str, relpath: str,
                rules: Sequence[Rule] = RULES,
                severity: str = "error",
                path: Optional[str] = None) -> List[Finding]:
    """Lint one source string. Returns findings with waivers applied and
    RL000 findings for unexplained or stale suppressions. ``path``, the
    file on disk the source stands for, lets RL003 follow the file's
    imports; without it RL003 stays within the source."""
    findings: List[Finding] = []
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding(rule_id="RL000", path=relpath,
                        line=e.lineno or 1,
                        message=f"file does not parse: {e.msg}",
                        severity="error")]

    waivers = _waivers(src)
    used: set = set()

    for rule in rules:
        if not rule.applies(relpath):
            continue
        for f in rule.check(tree, src, relpath, path=path):
            wline = next((ln for ln in (f.line, f.line - 1)
                          if f.rule_id in waivers.get(ln, ((), ""))[0]),
                         None)
            if wline is not None:
                waiver = waivers[wline]
                used.add(wline)
                if waiver[1]:
                    f = f._replace(waived=True, waive_reason=waiver[1])
                else:
                    findings.append(Finding(
                        rule_id="RL000", path=relpath, line=wline,
                        message=(f"waiver for {f.rule_id} has no reason — "
                                 f"`# {_TAG}: disable={f.rule_id} "
                                 f"<why>` is required"),
                        severity="error"))
            if f.severity != severity and not f.waived:
                f = f._replace(severity=severity)
            findings.append(f)

    # Waivers that never matched a finding are stale — surface them so
    # suppressions cannot silently outlive the code they excused.
    for wline, (ids, _) in waivers.items():
        if wline not in used:
            findings.append(Finding(
                rule_id="RL000", path=relpath, line=wline,
                message=(f"stale waiver for {', '.join(sorted(ids))}: no "
                         f"matching finding on this or the next line"),
                severity=severity))

    findings.sort(key=lambda f: (f.line, f.rule_id))
    return findings


def lint_file(path: str, root: str,
              rules: Sequence[Rule] = RULES,
              severity: str = "error") -> List[Finding]:
    relpath = os.path.relpath(path, root).replace(os.sep, "/")
    with open(path, "r", encoding="utf-8") as fh:
        src = fh.read()
    return lint_source(src, relpath, rules=rules, severity=severity,
                       path=os.path.abspath(path))


def _skip_dir(dirpath: str, name: str) -> bool:
    if name in _SKIP_DIRS:
        return True
    return name in _SKIP_UNLESS_PACKAGE and not os.path.isfile(
        os.path.join(dirpath, name, "__init__.py"))


def iter_py_files(paths: Iterable[str], root: str) -> List[str]:
    out: List[str] = []
    for p in paths:
        ap = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(ap) and ap.endswith(".py"):
            out.append(ap)
            continue
        for dirpath, dirnames, filenames in os.walk(ap):
            dirnames[:] = sorted(d for d in dirnames
                                 if not _skip_dir(dirpath, d))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    return out


def default_paths(root: str) -> List[str]:
    """The port's tree under the repository ``root``: its package
    (``src/repro_torch``), its tests (``tests/test_torch_*.py``) and the
    card smoke script (``chip_smoke.py``)."""
    tests = sorted(glob.glob(os.path.join(root, "tests", "test_torch_*.py")))
    return ([os.path.join(root, "src", "repro_torch")] + tests
            + [os.path.join(root, "chip_smoke.py")])


def lint_paths(paths: Iterable[str], root: str,
               rules: Sequence[Rule] = RULES,
               severity: str = "error") -> List[Finding]:
    findings: List[Finding] = []
    for f in iter_py_files(paths, root):
        findings.extend(lint_file(f, root, rules=rules, severity=severity))
    return findings

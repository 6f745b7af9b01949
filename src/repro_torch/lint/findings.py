"""Finding records and the machine-readable report
(``repro.lint.findings``' port).

One JSON document carries both layers (DESIGN.md §10): layer-1 AST
findings (``rule_id``/``path``/``line``/``message``/``severity``, plus
waiver state) and layer-2 audit results (one entry per checked entry
point). CI consumes the JSON; humans get the text rendering.
"""
from __future__ import annotations

import json
from typing import List, NamedTuple, Optional

__all__ = ["Finding", "AuditResult", "Report"]


class Finding(NamedTuple):
    """One layer-1 lint finding, anchored to a source line."""

    rule_id: str
    path: str          # repo-relative, forward slashes
    line: int
    message: str
    severity: str = "error"   # "error" | "warning"
    waived: bool = False
    waive_reason: str = ""

    def to_json(self) -> dict:
        return dict(self._asdict())

    def render(self) -> str:
        tag = f"[{self.rule_id}]"
        suffix = f"  (waived: {self.waive_reason})" if self.waived else ""
        return f"{self.path}:{self.line}: {tag} {self.message}{suffix}"


class AuditResult(NamedTuple):
    """One layer-2 auditor verdict for a public entry point."""

    check_id: str
    entry_point: str
    status: str        # "ok" | "fail" | "skip"
    detail: str = ""
    seconds: float = 0.0   # the check's wall time (obs.metrics.now)

    def to_json(self) -> dict:
        return dict(self._asdict())

    def render(self) -> str:
        return (f"{self.status.upper():5s} [{self.check_id}] "
                f"{self.entry_point} ({self.seconds:.2f} s): {self.detail}")


class Report(NamedTuple):
    findings: List[Finding]
    audit: List[AuditResult]

    # -- aggregation --------------------------------------------------------

    @property
    def active(self) -> List[Finding]:
        """Findings that count against the exit code (not waived)."""
        return [f for f in self.findings if not f.waived]

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.active if f.severity == "error"]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.active if f.severity == "warning"]

    @property
    def audit_failures(self) -> List[AuditResult]:
        return [a for a in self.audit if a.status == "fail"]

    def summary(self) -> dict:
        return {
            "errors": len(self.errors),
            "warnings": len(self.warnings),
            "waived": sum(1 for f in self.findings if f.waived),
            "audit_ok": sum(1 for a in self.audit if a.status == "ok"),
            "audit_fail": len(self.audit_failures),
            "audit_skip": sum(1 for a in self.audit if a.status == "skip"),
        }

    # -- rendering ----------------------------------------------------------

    def to_json(self, paths: Optional[List[str]] = None) -> str:
        return json.dumps(
            {
                "version": 1,
                "paths": paths or [],
                "findings": [f.to_json() for f in self.findings],
                "audit": [a.to_json() for a in self.audit],
                "summary": self.summary(),
            },
            indent=2,
        )

    def render_text(self) -> str:
        lines = []
        for f in self.findings:
            lines.append(f.render())
        if self.audit:
            if lines:
                lines.append("")
            lines.append("trace audit:")
            for a in self.audit:
                lines.append("  " + a.render())
        s = self.summary()
        if lines:
            lines.append("")
        lines.append(
            f"reprolint-torch: {s['errors']} error(s), {s['warnings']} "
            f"warning(s), {s['waived']} waived"
            + (f"; audit {s['audit_ok']} ok / {s['audit_fail']} fail / "
               f"{s['audit_skip']} skip" if self.audit else ""))
        return "\n".join(lines)

"""Structured findings: the one result type every analysis pass returns
(port of ``src/repro/analyze/findings.py``).

A *finding* is a single violated (or unprovable) invariant: which pass saw
it, how bad it is, where it is, which invariant it breaks, and enough detail
to reproduce.  Passes return ``list[Finding]``; an ``AnalysisReport``
aggregates the lists per target (matrix x backend/bucket) and decides the
exit status a CI gate consumes:

    error         the plan stack would compute a wrong factor (or crash a
                  real accelerator) — the strict gate fails
    warning       legal but suspect: a bucket outside its declared family,
                  a late prefetch
    inconclusive  the pass could not PROVE the invariant (e.g. a truncated
                  event trace) — deliberately distinct from PASS
    info          metrics and context, never gating

Severities are ordered so callers can threshold (``max_severity``).
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

#: ascending badness; index = rank
SEVERITIES = ("info", "inconclusive", "warning", "error")

#: the reference's kernel pass comes with the port's Hopper resource model
PASSES = ("plan-lint", "hazard", "cache")


def _rank(severity: str) -> int:
    return SEVERITIES.index(severity)


@dataclass(frozen=True)
class Finding:
    """One violated or unprovable invariant."""
    severity: str      # one of SEVERITIES
    pass_name: str     # one of PASSES
    code: str          # stable machine code, e.g. "scatter-oob"
    location: str      # where: "supernode 12", "level 3 group 0", "bucket (512, 256)"
    invariant: str     # the invariant checked, stated positively
    detail: str = ""   # free-form evidence

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")
        if self.pass_name not in PASSES:
            raise ValueError(f"unknown pass {self.pass_name!r}")

    def __str__(self) -> str:
        s = (f"[{self.severity.upper():12s}] {self.pass_name}/{self.code} "
             f"at {self.location}: {self.invariant}")
        return s + (f" — {self.detail}" if self.detail else "")


@dataclass
class AnalysisReport:
    """Findings + metrics for one analysis target (one matrix/plan)."""
    target: str                      # e.g. "lap2d_64[fused]"
    findings: list = field(default_factory=list)
    metrics: dict = field(default_factory=dict)

    def extend(self, findings) -> "AnalysisReport":
        self.findings.extend(findings)
        return self

    def by_severity(self, severity: str) -> list:
        return [f for f in self.findings if f.severity == severity]

    @property
    def errors(self) -> list:
        return self.by_severity("error")

    @property
    def warnings(self) -> list:
        return self.by_severity("warning")

    def max_severity(self) -> str | None:
        return max((f.severity for f in self.findings), key=_rank, default=None)

    def status(self, pass_name: str | None = None) -> str:
        """PASS / WARN / INCONCLUSIVE / FAIL for one pass (or the whole
        target).  INCONCLUSIVE outranks WARN: an unprovable invariant is
        worse news than a proven-but-tolerated one."""
        fs = [f for f in self.findings
              if pass_name is None or f.pass_name == pass_name]
        worst = max((f.severity for f in fs), key=_rank, default=None)
        return {None: "PASS", "info": "PASS", "warning": "WARN",
                "inconclusive": "INCONCLUSIVE", "error": "FAIL"}[worst]

    def summary(self) -> str:
        lines = [f"== {self.target}"]
        for p in PASSES:
            if any(f.pass_name == p for f in self.findings) or p != "cache":
                lines.append(f"   {p:10s} {self.status(p)}")
        for f in sorted(self.findings, key=lambda f: -_rank(f.severity)):
            if f.severity != "info":
                lines.append(f"   {f}")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {
            "target": self.target,
            "status": self.status(),
            "findings": [asdict(f) for f in self.findings],
            "metrics": self.metrics,
        }


def report_json(reports: list) -> str:
    """Machine-readable aggregate for the CI artifact."""
    return json.dumps({
        "reports": [r.to_dict() for r in reports],
        "errors": sum(len(r.errors) for r in reports),
        "warnings": sum(len(r.warnings) for r in reports),
    }, indent=2)

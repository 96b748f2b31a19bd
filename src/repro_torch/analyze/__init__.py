"""Static analysis of the precomputed-plan stack (port of
``src/repro/analyze``).  Three passes, each returning structured
``Finding``s, runnable without the numeric phase:

    plan lint     repro_torch.analyze.plan_lint     index plans self-consistent
    hazards       repro_torch.analyze.hazards       happens-before (static +
                                                    trace)
    cache         repro_torch.analyze.cache_check   saved-plan integrity

``CachedPlan.load(lint=True)`` and the server's verify mode
(``CholeskyServer(verify=True)``) run them.  The reference's kernel pass
(its VMEM model) and its ``analyze_matrix`` / CLI are not ported yet.
"""
from repro_torch.analyze.cache_check import check_plan_file
from repro_torch.analyze.findings import (
    AnalysisReport,
    Finding,
    PASSES,
    SEVERITIES,
    report_json,
)
from repro_torch.analyze.hazards import (
    audit_engine,
    audit_trace,
    plan_happens_before,
    traced_factorization,
)
from repro_torch.analyze.plan_lint import (
    lint_device_plan,
    lint_fill_plan,
    lint_plan_stack,
    lint_scatter_plan,
    lint_schedule,
)

__all__ = [
    "AnalysisReport", "Finding", "PASSES", "SEVERITIES", "report_json",
    "audit_engine", "audit_trace", "plan_happens_before",
    "traced_factorization", "lint_device_plan", "lint_fill_plan",
    "lint_plan_stack", "lint_scatter_plan", "lint_schedule",
    "check_plan_file",
]

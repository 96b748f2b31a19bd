"""Static analysis of the precomputed-plan stack (port of
``src/repro/analyze``).  Four passes, each returning structured
``Finding``s, runnable without the numeric phase:

    plan lint     repro_torch.analyze.plan_lint     index plans self-consistent
    hazards       repro_torch.analyze.hazards       happens-before (static +
                                                    trace)
    kernel        repro_torch.analyze.kernel_check  shared memory / threads /
                                                    grid / tile waste
    cache         repro_torch.analyze.cache_check   saved-plan integrity

``CachedPlan.load(lint=True)`` and the server's verify mode
(``CholeskyServer(verify=True)``) run them; ``analyze_matrix`` runs every
pass over one matrix.

CLI: ``python -m repro_torch.analyze --all-generators --strict``.
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
from repro_torch.analyze.kernel_check import (
    HOPPER_SMEM_PER_BLOCK,
    bucket_smem,
    check_bucket,
    check_kernels,
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
    "traced_factorization", "HOPPER_SMEM_PER_BLOCK", "bucket_smem",
    "check_bucket", "check_kernels", "lint_device_plan", "lint_fill_plan",
    "lint_plan_stack", "lint_scatter_plan", "lint_schedule",
    "check_plan_file", "analyze_matrix",
]


def analyze_matrix(A, *, name: str = "matrix", families=("batch", "fused"),
                   smem_cap: int | None = None, max_batch: int = 256,
                   trace_devices=(), fill: bool = True) -> AnalysisReport:
    """Run every static pass over one matrix: symbolic pipeline, then plan
    lint + static hazard happens-before + kernel checks per bucket family
    (and, for each device in ``trace_devices`` — ``"cuda"``, ``"cpu"`` —
    one real factorization whose event trace is audited: the only part
    that runs numerics)."""
    from repro_torch.core.api import symbolic_pipeline
    from repro_torch.core.device_store import device_plan
    from repro_torch.core.plan_cache import build_fill_plan, canonical_csc
    from repro_torch.core.schedule import cached_schedule

    A = canonical_csc(A)
    sym, _Aperm = symbolic_pipeline(A)
    rep = AnalysisReport(target=name)
    rep.extend(lint_scatter_plan(sym))
    if fill:
        fs, fd = build_fill_plan(sym, A)
        rep.extend(lint_fill_plan(sym, fs, fd, int(A.nnz)))
    rep.metrics["families"] = {}
    for family in families:
        sched = cached_schedule(sym, max_batch=max_batch, bucket=family)
        gp = device_plan(sym, sched)
        rep.extend(lint_schedule(sym, sched, bucket=family))
        rep.extend(lint_device_plan(sym, sched, gp))
        rep.extend(plan_happens_before(sym, sched, gp))
        kf, km = check_kernels(sym, sched, family=family, smem_cap=smem_cap)
        rep.extend(kf)
        rep.metrics["families"][family] = km
    for device in trace_devices:
        rep.extend(traced_factorization(A, device=device)[0])
    return rep

"""Public API of the port:

    from repro_torch.core import cholesky
    F = cholesky(A)                       # on the card; device="cpu" on the host
    x = F.solve(b, backend="device")

``cholesky`` routes as the reference's ``cholesky`` does, with a device
engine always present (the port's entry points run on the card unless asked
for the CPU):

    schedule='levels' (default)  ``factorize_levels``: fully device-resident
                                 at a zero offload threshold (the main path),
                                 host assembly with device batches above it
                                 or with ``assembly='host'``
    schedule='seq'               the paper's one-supernode-at-a-time loops,
                                 ``factorize_rl`` / ``factorize_rlb``, with
                                 supernodes of rows*w >= offload_threshold
                                 on the device and the rest in numpy

``guard=`` adds the breakdown guard (``core/guard.py``: detection in the
guarded kernel on the device-resident path, numpy's LinAlgError on the host
paths, perturb-and-refine, diagonal-shift retries).  Repeat-pattern streams
skip the symbolic phase through the plan cache (``core/plan_cache.py``):

    cache = PlanCache()
    plan = cache.get(A)                              # analysed once
    F = cholesky(A2, plan=plan)                      # numeric only
    Fs = cholesky_many([A3, A4], plan=plan)          # one dispatch set
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from repro_torch.core.engines import DeviceEngine
from repro_torch.core.guard import (
    BreakdownError,
    GuardReport,
    perturb_threshold,
    validate_matrix,
)
from repro_torch.core.merge import merge_supernodes
from repro_torch.core.numeric import (
    BatchCholeskyFactor,
    CholeskyFactor,
    HostEngine,
    OffloadPolicy,
    PanelStore,
    _factorize_levels_device,
    factorize_levels,
    factorize_levels_device_many,
    factorize_rl,
    factorize_rlb,
)
from repro_torch.core.refine import refine_partition
from repro_torch.core.spans import span
from repro_torch.core.symbolic import SymbolicFactor, symbolic_analyze
from repro_torch.sparse.ordering import fill_reducing_ordering


def symbolic_pipeline(
    A: sp.spmatrix,
    *,
    ordering: str = "nd",
    merge: bool = True,
    refine: bool = True,
    max_growth: float = 0.25,
) -> tuple[SymbolicFactor, sp.csc_matrix]:
    """The paper's preprocessing pipeline: fill-reducing ordering ->
    symbolic factorization -> supernode amalgamation (25% storage cap) ->
    partition refinement.  Returns (sym, permuted matrix)."""
    A = sp.csc_matrix(A)
    order = fill_reducing_ordering(A, ordering)
    sym, Aperm = symbolic_analyze(A, order=order)
    if merge:
        sym = merge_supernodes(sym, max_growth=max_growth)
    if refine:
        sym, g = refine_partition(sym)
        Aperm = Aperm[g][:, g].tocsc()
        Aperm.sort_indices()
    return sym, Aperm


def cholesky(
    A: sp.spmatrix,
    *,
    method: str = "rl",
    ordering: str = "nd",
    merge: bool = True,
    refine: bool = True,
    max_growth: float = 0.25,
    device=None,
    device_engine: DeviceEngine | None = None,
    offload_threshold: int | None = None,
    batch_transfers: bool = False,
    schedule: str | None = None,
    max_batch: int = 256,
    assembly: str = "auto",
    staging: str | None = None,
    sym: SymbolicFactor | None = None,
    Aperm: sp.csc_matrix | None = None,
    plan=None,
    guard: str = "off",
) -> CholeskyFactor:
    """Factor a sparse SPD matrix.

    method             'rl' or 'rlb' (the sequential schedule's variant; the
                       levels schedule always runs the RL formulation)
    device             'cuda' (default; raises without a card) or 'cpu' (the
                       kernels' plain PyTorch versions); sets the engine when
                       ``device_engine`` is not given
    device_engine      a DeviceEngine to run on (its stats and events record
                       the run); ``DeviceEngine(fused=False)`` makes the
                       sequential path call potrf, trsm_rlt and syrk_ln
                       instead of the fused kernel
    offload_threshold  supernodes with rows*w >= this run on the device, the
                       rest in numpy (None or 0: all on the device); the
                       paper uses 600,000 for RL and 750,000 for RLB
    batch_transfers    RLB on 'seq' only: keep a supernode's block updates on
                       the device and read them back in one transfer
    schedule           'levels' (default) or 'seq'
    assembly           levels only: 'auto', 'host' or 'device' (see
                       ``factorize_levels``)
    staging            device-resident levels path only: 'async' (default)
                       or 'sync'
    sym / Aperm        reuse a symbolic factorization; ``sym`` alone is
                       enough, the permuted matrix is rebuilt from ``sym.perm``
    plan               a CachedPlan (``core/plan_cache.py``): no symbolic
                       phase at all, and on the device-resident path the
                       panel fill is one vectorized gather through the
                       plan's fill indices
    guard              breakdown policy (``core/guard.py``):
                       'off'     no detection: the unguarded kernel
                       'raise'   validate the input, detect non-positive or
                                 nonfinite pivots in the guarded kernel,
                                 raise BreakdownError naming the first
                                 broken supernode
                       'perturb' clamp pivots below eps*4096*max|diag(A)|
                                 (or the element-growth floor) during
                                 elimination, recorded in the GuardReport;
                                 solves refine against the original matrix
                       'shift'   retry with a growing diagonal shift until
                                 clean; solves refine against the original
                       In-kernel detection needs the device-resident levels
                       path; the host paths detect through numpy's
                       LinAlgError, and 'perturb' raises ValueError there.

    The other arguments mirror the reference's ``cholesky``.
    """
    if method not in ("rl", "rlb"):
        raise ValueError(f"unknown method {method!r} (want 'rl' or 'rlb')")
    if schedule is None:
        schedule = "levels"
    if schedule not in ("seq", "levels"):
        raise ValueError(f"unknown schedule {schedule!r} (want 'seq' or 'levels')")
    if assembly not in ("auto", "host", "device"):
        raise ValueError(
            f"unknown assembly {assembly!r} (want 'auto', 'host', or 'device')"
        )
    if assembly != "auto" and schedule == "seq":
        raise ValueError(
            f"assembly={assembly!r} only applies to schedule='levels' "
            "(the sequential paths always assemble on the host)"
        )
    if batch_transfers and schedule == "levels":
        raise ValueError(
            "batch_transfers applies only to the sequential RLB path; "
            "pass schedule='seq'"
        )
    if plan is not None and sym is None:
        sym = plan.sym
    if staging is not None and schedule != "levels":
        raise ValueError(
            "staging applies only to the device-resident levels schedule"
        )
    if guard not in ("off", "raise", "perturb", "shift"):
        raise ValueError(
            f"unknown guard {guard!r} (want 'off', 'raise', 'perturb', or "
            "'shift')"
        )
    if device_engine is None:
        device_engine = DeviceEngine(device=device)
    elif device is not None and device_engine.device.type != \
            torch.device(device).type:
        raise ValueError(
            f"device={device!r} disagrees with the engine's device "
            f"{device_engine.device}"
        )
    policy = OffloadPolicy(threshold=offload_threshold or 0)
    device_resident = (schedule == "levels" and assembly != "host"
                       and (assembly == "device" or policy.threshold == 0))
    gval, gkw = None, {}
    if guard != "off":
        with span("guard.validate"):
            gval = validate_matrix(A)  # BadMatrixError on NaN/Inf/asym
        if guard == "shift":
            # retry loop over guard='raise' with growing diagonal shifts
            return _cholesky_shift(
                A, gval,
                dict(method=method, device_engine=device_engine,
                     offload_threshold=offload_threshold, schedule=schedule,
                     max_batch=max_batch, assembly=assembly, staging=staging,
                     ordering=ordering, merge=merge, refine=refine,
                     max_growth=max_growth, sym=sym, plan=plan),
            )
        if device_resident:
            # in-kernel detection: the status rides the one read-back
            if guard == "raise":
                gkw = dict(guard="raise", guard_thr=0.0, guard_clamp=False)
            else:
                gkw = dict(guard="perturb", guard_clamp=True,
                           guard_thr=perturb_threshold(gval["max_abs_diag"]))
        elif guard == "perturb":
            raise ValueError(
                "guard='perturb' needs in-kernel pivot clamps, i.e. the "
                "fully-offloaded device-resident levels path (device engine "
                "+ full offload); use guard='shift' on host paths"
            )
    if plan is not None and device_resident:
        # plan fast path: the panel fill as ONE vectorized gather, no
        # permuted matrix is ever built
        with span("factor.fill"):
            store = PanelStore(sym, storage=plan.fill_storage(A))
        F = _factorize_levels_device(
            sym, None, device_engine, max_batch=max_batch, staging=staging,
            store=store, **gkw,
        )
        return F if guard == "off" else _attach_guard(F, A, guard, gval)
    if sym is None:
        sym, Aperm = symbolic_pipeline(
            A, ordering=ordering, merge=merge, refine=refine,
            max_growth=max_growth,
        )
    elif Aperm is None:
        # sym.perm already folds in any refinement reordering
        p = sym.perm
        Aperm = sp.csc_matrix(A)[p][:, p].tocsc()
        Aperm.sort_indices()
    try:
        if schedule == "levels":
            F = factorize_levels(
                sym, Aperm, engine=HostEngine(), device_engine=device_engine,
                policy=policy, max_batch=max_batch, assembly=assembly,
                staging=staging, **gkw,
            )
        elif method == "rl":
            F = factorize_rl(sym, Aperm, engine=HostEngine(),
                             device_engine=device_engine, policy=policy)
        else:
            F = factorize_rlb(sym, Aperm, engine=HostEngine(),
                              device_engine=device_engine, policy=policy,
                              batch_transfers=batch_transfers)
    except np.linalg.LinAlgError as e:
        # host-path breakdown: numpy's potrf failure, upgraded to the same
        # structured error the in-kernel guard raises
        if guard == "off":
            raise
        rep = GuardReport(guard=guard, n_supernodes=int(sym.nsuper),
                          min_pivot=float("nan"), validation=gval)
        rep.broken.append({"supernode": None, "level": None,
                           "min_pivot": float("nan"), "nonfinite": False})
        raise BreakdownError(rep, f"Cholesky breakdown: {e}") from e
    return F if guard == "off" else _attach_guard(F, A, guard, gval)


def _attach_guard(F: CholeskyFactor, A, guard: str, val) -> CholeskyFactor:
    """Finish a guarded factorization (the reference's ``_attach_guard``):
    attach the validation info, raise on unrecovered breakdown, and record
    the original matrix where solves must refine against it.  A factor of
    a path without in-kernel detection gets a clean report with its least
    d^2 from the panels; like the reference's, that minimum skips a NaN
    pivot (``min(m, nan)`` keeps m), so such a factor can hold NaN under an
    ``ok`` report (ROADMAP section 3)."""
    with span("guard.report"):
        rep = F.guard_report
        if rep is None:
            rep = GuardReport(guard=guard, n_supernodes=int(F.sym.nsuper))
            m = float("inf")
            for s in range(F.sym.nsuper):
                w = F.sym.width(s)
                d = np.diagonal(F.panels[s][:w, :w])
                if w:
                    m = min(m, float(np.min(d * d)))
            rep.min_pivot = m
            F.guard_report = rep
        rep.guard = guard
        rep.validation = val
        if not rep.ok:
            raise BreakdownError(rep)
        if rep.needs_refine:
            F.guard_A = sp.csc_matrix(A)
        return F


def _cholesky_shift(A, val, kw):
    """guard='shift' recovery (the reference's ``_cholesky_shift``):
    refactor with a growing diagonal shift A + tau*I until the guarded
    factorization comes back clean.  Solves against the returned factor
    refine toward the ORIGINAL unshifted system."""
    A = sp.csc_matrix(A)
    n = int(A.shape[0])
    tau0 = max(perturb_threshold(val["max_abs_diag"]),
               float(np.finfo(np.float64).tiny))
    tau, shifts, last = 0.0, 0, None
    for _ in range(30):  # 10x per step: overshoots the minimal shift by <10x
        Ak = A if tau == 0.0 else (A + tau * sp.eye(n, format="csc")).tocsc()
        try:
            kwk = kw if tau == 0.0 else dict(kw, plan=None)  # pattern may gain diag
            if kwk.get("plan") is None and kw.get("plan") is not None:
                kwk["sym"] = kw["plan"].sym if kw.get("sym") is None else kw["sym"]
            F = cholesky(Ak, guard="raise", **kwk)
        except BreakdownError as e:
            last = e
            shifts += 1
            tau = tau0 * (10.0 ** (shifts - 1))
            continue
        rep = F.guard_report
        rep.guard = "shift"
        rep.shift = float(tau)
        rep.shifts = shifts
        rep.validation = val
        if tau > 0.0:
            F.guard_A = A  # refine solves back to the unshifted system
        return F
    rep = last.report
    rep.guard = "shift"
    rep.shift = float(tau)
    rep.shifts = shifts
    raise BreakdownError(
        rep, f"shift recovery failed after {shifts} shifts "
        f"(last tau = {tau:.3g}): {last}"
    ) from last


def cholesky_many(
    As,
    *,
    device=None,
    device_engine: DeviceEngine | None = None,
    plan=None,
    sym: SymbolicFactor | None = None,
    ordering: str = "nd",
    merge: bool = True,
    refine: bool = True,
    max_batch: int = 256,
    staging: str | None = None,
    guard: str = "off",
) -> BatchCholeskyFactor:
    """Factor M sparse SPD matrices sharing ONE sparsity pattern with a
    single set of device dispatches (the reference's ``cholesky_many``).

    The value arrays stack behind a leading matrix axis through the whole
    device-resident pipeline (staged chunks, update pool, packed factor), so
    each (level x bucket) group factors all M matrices in ONE fused kernel
    call of M*batch lanes.

    As             matrices with identical sparsity patterns
    device /       as for ``cholesky`` (the card unless ``device='cpu'``)
    device_engine
    plan           CachedPlan of the shared pattern; None analyses As[0]
                   once and builds a plan here (``sym`` skips the analysis)
    guard          'off', 'raise' or 'perturb' ('shift' is single-matrix
                   only); perturb uses the largest of the M thresholds

    Returns a BatchCholeskyFactor: per-matrix zero-copy factors through
    ``.factor(i)``, all-matrix resident solves through ``.solve(b)``.
    """
    from repro_torch.core.plan_cache import (
        CachedPlan,
        build_fill_plan,
        canonical_csc,
        pattern_fingerprint,
    )
    from repro_torch.core.relind import scatter_plan

    As = list(As)
    if not As:
        raise ValueError("cholesky_many needs at least one matrix")
    if guard not in ("off", "raise", "perturb"):
        raise ValueError(
            f"unknown guard {guard!r} for cholesky_many (want 'off', "
            "'raise', or 'perturb'; 'shift' is single-matrix only)"
        )
    gvals, gkw = None, {}
    if guard != "off":
        with span("guard.validate"):
            gvals = [validate_matrix(Ai) for Ai in As]
        if guard == "raise":
            gkw = dict(guard="raise")
        else:
            # one thr per kernel call covers all M lanes: the most
            # conservative (largest-diagonal) matrix's threshold
            gkw = dict(
                guard="perturb", guard_clamp=True,
                guard_thr=max(perturb_threshold(v["max_abs_diag"])
                              for v in gvals),
            )
    if plan is None:
        if sym is None:
            sym, _Aperm = symbolic_pipeline(
                As[0], ordering=ordering, merge=merge, refine=refine
            )
        A0 = canonical_csc(As[0])
        fill_src, fill_dst = build_fill_plan(sym, A0)
        plan = CachedPlan(
            key=pattern_fingerprint(A0), sym=sym, fill_src=fill_src,
            fill_dst=fill_dst, n=A0.shape[0], nnz=int(A0.nnz),
        )
    if device_engine is None:
        device_engine = DeviceEngine(device=device)
    M = len(As)
    cells = int(scatter_plan(plan.sym).storage_cells)
    with span("factor.fill"):
        storage = np.zeros((M, cells), dtype=np.float64)
        for i, A in enumerate(As):
            plan.fill_storage(A, row=storage[i])
    BF = factorize_levels_device_many(
        plan.sym, storage, device_engine, max_batch=max_batch,
        staging=staging, **gkw,
    )
    if guard != "off":
        with span("guard.report"):
            for rep, v in zip(BF.guard_reports, gvals):
                rep.validation = v
            bad = [r for r in BF.guard_reports if not r.ok]
            if bad:
                raise BreakdownError(bad[0])
            if guard == "perturb":
                BF.guard_As = [
                    sp.csc_matrix(Ai) if rep.needs_refine else None
                    for Ai, rep in zip(As, BF.guard_reports)
                ]
    return BF


def solve(A: sp.spmatrix, b: np.ndarray, *, solve_backend: str = "host",
          **kw) -> np.ndarray:
    """Factor-and-solve convenience wrapper.  ``solve_backend`` picks the
    substitution path ('host' loop or 'device' level-scheduled batched —
    see CholeskyFactor.solve); every other keyword goes to ``cholesky``."""
    return cholesky(A, **kw).solve(b, backend=solve_backend)

"""Pass 2 — async-staging hazard checker: happens-before over the plan and
over ``DeviceEngine.events`` (port of ``src/repro/analyze/hazards.py``).

The async staging path uploads each level's packed-storage chunk with a
``put_async`` issued *before* the previous level's dispatches
(``device_store.prefetch_level``), relying on two happens-before facts:

  * data   — a level-k group reads only pool entries *produced* by strictly
             earlier levels (else the prefix-sum assembly reads garbage);
  * issue  — a level-k dispatch must be issued after level k's chunk upload
             (``DeviceEngine.wait`` orders the compute stream after an
             upload's event — but only if the upload WAS issued before it).

``plan_happens_before`` proves the data fact statically from the plan
alone.  ``audit_trace`` verifies the issue fact (plus dispatch-level
monotonicity and donation discipline) over a recorded engine event log; when
the engine's ring buffer overflowed, the verdict is INCONCLUSIVE — a
truncated trace can hide the violation, so it must not report PASS.

The donation check stays, but the port's engine never logs a
``donation_reuse`` event: it donates no buffer to a program (the update
pool and the solve RHS are updated in place), so the check never fires on
a real trace.
"""
from __future__ import annotations

import numpy as np

from repro_torch.analyze.findings import Finding

_P = "hazard"


def _err(code, loc, inv, detail=""):
    return Finding("error", _P, code, loc, inv, detail)


# ---------------------------------------------------------------------------
# static: pool dataflow happens-before + chunk-slice bounds
# ---------------------------------------------------------------------------
def plan_happens_before(sym, sched, gp=None) -> list:
    """Prove from the plan alone that every value a group reads exists by
    the time it runs: incoming pool entries come from strictly earlier
    levels, and the group's slice of its level chunk is in bounds."""
    from repro_torch.analyze.plan_lint import _pool_destinations
    from repro_torch.core.device_store import device_plan

    gp = gp if gp is not None else device_plan(sym, sched)
    out: list = []
    _dest, _producer, pool_off = _pool_destinations(sym, sched, gp)
    flat = [(li, gi, g) for li, lg in enumerate(gp.groups)
            for gi, g in enumerate(lg)]
    glevel = np.array([li for li, _gi, _g in flat], dtype=np.int64)
    lb_ = np.asarray(gp.level_base, dtype=np.int64)
    for li, gi, g in flat:
        loc = f"level {li} group {gi}"
        src = np.asarray(g.src, dtype=np.int64)
        if src.size:
            prod = np.searchsorted(pool_off, src, side="right") - 1
            prod = np.clip(prod, 0, glevel.shape[0] - 1)
            late = glevel[prod] >= li
            if late.any():
                k = int(np.flatnonzero(late)[0])
                out.append(_err(
                    "pool-hb", loc,
                    "incoming update entries are produced at strictly "
                    "earlier levels (all contributions in the pool before "
                    "the group runs)",
                    f"pool slot {int(src[k])} is produced at level "
                    f"{int(glevel[prod[k]])}",
                ))
        r = int(np.asarray(g.cells).shape[0])
        clen = int(lb_[li + 1] - lb_[li])
        if int(g.lb) < 0 or int(g.lb) + r > clen:
            out.append(_err(
                "chunk-bounds", loc,
                "the group's slice stays inside its level chunk",
                f"slice [{int(g.lb)}, {int(g.lb) + r}) vs chunk length {clen}",
            ))
    return out


# ---------------------------------------------------------------------------
# dynamic: happens-before over the recorded event trace
# ---------------------------------------------------------------------------
def audit_trace(events, *, n_levels: int | None = None,
                staging: str = "async", overflowed: bool = False) -> list:
    """Verify a ``DeviceEngine.events`` log (a sequence of ``(tag, level)``
    2-tuples in issue order).  Checks, for async staging:

      * read-before-upload — every level's first dispatch is preceded by
        that level's chunk upload;
      * level-order        — dispatch levels are non-decreasing (a group
        issued before a producer level completes would read stale pool);
      * late-prefetch      — (warning) the level-(k+1) upload should be
        issued before level k's dispatches, else nothing overlaps;
      * donation-reuse     — any ``donation_reuse`` event is an error: a
        donated buffer was passed to a device program again (its storage
        may already be reused; the port's engine logs none);
      * missing-level      — with ``n_levels`` given, every level dispatched.

    A truncated trace (ring-buffer ``overflowed``) downgrades the whole
    audit to INCONCLUSIVE: the dropped prefix could contain the violation.
    """
    out: list = []
    if overflowed:
        out.append(Finding(
            "inconclusive", _P, "trace-truncated", "event log",
            "the full event trace is required to prove ordering",
            "DeviceEngine.events overflowed its ring buffer; earliest "
            "events were dropped (raise events_cap or reset_events per run)",
        ))
    uploaded: set = set()
    dispatched: list = []
    last_lvl = None
    for i, ev in enumerate(events):
        tag, lvl = ev[0], int(ev[1])
        loc = f"event {i}"
        if tag == "upload":
            uploaded.add(lvl)
            if dispatched and lvl <= max(dispatched):
                out.append(Finding(
                    "warning", _P, "late-prefetch", loc,
                    "chunk uploads are issued before the previous level's "
                    "dispatches (double buffering)",
                    f"upload of level {lvl} issued after a level "
                    f"{max(dispatched)} dispatch",
                ))
        elif tag == "dispatch":
            if lvl < 0:
                out.append(Finding(
                    "warning", _P, "untagged-dispatch", loc,
                    "dispatches carry their level for order auditing"))
                continue
            if staging == "async" and lvl not in uploaded and not overflowed:
                out.append(_err(
                    "read-before-upload", loc,
                    "no dispatch reads a chunk whose upload has not been "
                    "issued",
                    f"level {lvl} dispatched with no prior upload event",
                ))
            if last_lvl is not None and lvl < last_lvl:
                out.append(_err(
                    "level-order", loc,
                    "dispatch levels are non-decreasing (producers before "
                    "consumers)",
                    f"level {lvl} dispatched after level {last_lvl}",
                ))
            last_lvl = lvl
            dispatched.append(lvl)
        elif tag == "donation_reuse":
            out.append(_err(
                "donation-reuse", loc,
                "a donated device buffer is never passed to a program "
                "again (its storage may be reused on real hardware)",
                f"stale buffer re-entered a level-{lvl} program",
            ))
    if n_levels is not None and not overflowed:
        missing = sorted(set(range(n_levels)) - set(dispatched))
        if missing:
            out.append(_err(
                "missing-level", "event log",
                "every schedule level is dispatched",
                f"levels {missing[:8]} never dispatched",
            ))
    return out


def audit_engine(eng, *, n_levels: int | None = None,
                 staging: str = "async") -> list:
    """Audit a live engine's recorded trace (overflow-aware)."""
    return audit_trace(
        list(eng.events), n_levels=n_levels, staging=staging,
        overflowed=bool(getattr(eng, "events_overflowed", False)),
    )


def traced_factorization(A, *, device=None, staging: str = "async",
                         max_batch: int = 256):
    """Run one real factorization purely to harvest its event trace, then
    audit it.  Returns (findings, engine, factor) — the opt-in dynamic
    complement to ``plan_happens_before``."""
    from repro_torch.core.api import cholesky
    from repro_torch.core.engines import DeviceEngine
    from repro_torch.core.schedule import cached_schedule

    eng = DeviceEngine(device=device)
    F = cholesky(A, device_engine=eng, max_batch=max_batch, staging=staging)
    # same bucket choice as numeric._factorize_levels_device — a cache hit
    sched = cached_schedule(F.sym, max_batch=max_batch,
                            bucket=F.stats["bucket"])
    findings = audit_engine(eng, n_levels=sched.n_levels, staging=staging)
    return findings, eng, F

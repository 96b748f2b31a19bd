"""Numeric supernodal right-looking Cholesky: the RL and RLB variants, and
the level-scheduled paths.

Port of ``src/repro/core/numeric.py``.  Both variants factor the current
supernode with POTRF + TRSM, then push its updates right:

  * RL    one SYRK computes the whole update matrix U = L_tail L_tail^T,
          scattered into every ancestor through the precomputed scatter plan
          (``PanelStore.scatter``);
  * RLB   one SYRK (diagonal target) or GEMM (off-diagonal target) per block
          pair, applied directly to the ancestor panels.

The dense math goes through an *engine*: ``HostEngine`` (numpy/scipy, the
paper's CPU-only baseline, copied verbatim from the reference) or the
port's ``DeviceEngine`` for the supernodes ``OffloadPolicy`` sends to the
card (the paper's GPU version); assembly stays on the host.

``factorize_levels`` runs supernodes level by level up the etree, each
(level x bucket) batch through the engines' batched protocol with host
assembly, or — with every supernode offloaded — goes fully device-resident
(``_factorize_levels_device``, see ``repro_torch.core.device_store``):
the flat storage is staged once, every group is ONE fused dispatch, and the
factor is read back once.  ``CholeskyFactor`` solves on the host (the
paper's per-supernode loop) or on the device (level-scheduled batched
substitution against the device-resident factor, staged from the host
factor when there is none).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp

from repro_torch.core.relind import (
    ancestor_updates,
    scatter_plan,
    supernode_blocks,
)
from repro_torch.core.schedule import cached_schedule
from repro_torch.core.spans import span
from repro_torch.core.symbolic import SymbolicFactor


# ---------------------------------------------------------------------------
# host engine: the paper's CPU-only baseline (BLAS/LAPACK via numpy/scipy)
# ---------------------------------------------------------------------------
class HostEngine:
    name = "host"

    def stage(self, P: np.ndarray, w: int):
        return (P, w)

    def factor(self, h) -> None:
        P, w = h
        Ld = np.linalg.cholesky(P[:w, :w])
        P[:w, :w] = Ld
        if P.shape[0] > w:
            # TRSM: X = B L^{-T}  <=>  L Y = B^T, X = Y^T
            P[w:] = sla.solve_triangular(Ld, P[w:].T, lower=True).T

    def read_panel(self, h) -> np.ndarray:
        return h[0]

    def syrk_tail(self, h) -> np.ndarray:
        P, w = h
        B = P[w:]
        return B @ B.T

    def syrk_block(self, h, k0: int, k1: int) -> np.ndarray:
        P, w = h
        B = P[w + k0:w + k1]
        return B @ B.T

    def gemm_block(self, h, kr0: int, kr1: int, kc0: int, kc1: int) -> np.ndarray:
        P, w = h
        return P[w + kr0:w + kr1] @ P[w + kc0:w + kc1].T

    def gather(self, xs) -> list:
        return [np.asarray(x) for x in xs]

    def fetch(self, x) -> np.ndarray:
        return np.asarray(x)

    def release(self, h) -> None:
        pass

    def flush(self) -> None:
        pass

    # -- batched protocol (level-scheduled path) ---------------------------
    # Host batches are plain per-item loops over the scalar ops: numerically
    # identical to the sequential path, and the protocol symmetry lets
    # factorize_levels treat host and device engines uniformly.
    def stage_batch(self, Ps: list, ws: list) -> list:
        return [self.stage(P, w) for P, w in zip(Ps, ws)]

    def factor_batch(self, hs: list) -> None:
        for h in hs:
            self.factor(h)

    def read_panels_batch(self, hs: list) -> list:
        return [self.read_panel(h) for h in hs]

    def syrk_tail_batch(self, hs: list) -> list:
        return [self.syrk_tail(h) if h[0].shape[0] > h[1] else None for h in hs]

    def release_batch(self, hs: list) -> None:
        pass


@dataclass
class OffloadPolicy:
    """The paper's size threshold: supernodes with rows*width >= threshold run
    on the accelerator, everything smaller stays on the host.
    (Paper: 600,000 for RL, 750,000 for RLB on an A100.)"""
    threshold: int = 600_000

    def on_device(self, sym: SymbolicFactor, s: int) -> bool:
        return sym.size(s) >= self.threshold


# ---------------------------------------------------------------------------
# factor container
# ---------------------------------------------------------------------------
@dataclass
class CholeskyFactor:
    sym: SymbolicFactor
    panels: list  # list of (rows_s, w_s) float64 arrays; cols are factor cols
    stats: dict | None = None
    # flat-storage backing of ``panels`` and the device mirror
    # (repro_torch.core.device_store.DevicePanelStore) holding the factor on
    # the device for transfer-free solves
    store: object | None = None
    dstore: object | None = None
    # the DeviceEngine that made this factor (None for a host-only one): a
    # device solve without a resident factor stages the host factor with it
    engine: object | None = None
    # breakdown-guard extras (guarded factorizations only): the reduced
    # GuardReport, and the original matrix solves refine against when the
    # factor carries recorded perturbations or a shift
    guard_report: object | None = None
    guard_A: object | None = None

    def L_dense(self) -> np.ndarray:
        """The full dense L (for small-n validation only)."""
        n = self.sym.n
        L = np.zeros((n, n))
        for s in range(self.sym.nsuper):
            f = int(self.sym.super_ptr[s])
            w = self.sym.width(s)
            r = self.sym.rows[s]
            P = self.panels[s]
            for c in range(w):
                L[r[c:], f + c] = P[c:, c]
        return L

    def factor_nnz(self) -> int:
        return self.sym.factor_nnz()

    def logdet(self) -> float:
        acc = 0.0
        for s in range(self.sym.nsuper):
            w = self.sym.width(s)
            d = np.diagonal(self.panels[s][:w, :w])
            acc += float(np.sum(np.log(d)))
        return 2.0 * acc

    def solve(self, b: np.ndarray, *, backend: str = "host",
              engine=None, refine: bool | None = None) -> np.ndarray:
        """Solve A x = b using P A P^T = L L^T.

        backend  'host' (per-supernode scipy loop, the paper's solve) or
                 'device' (level-scheduled batched substitution against the
                 device-resident factor; a factor that has none — from the
                 sequential or mixed paths, or from another package's
                 storage — is staged once and stays resident for later
                 solves).
        engine   device backend only: the DeviceEngine to stage with when no
                 device-resident factor exists (default: the factor's own
                 engine, else a new one on the card).
        refine   refine against the original matrix (guarded factorizations
                 only; ``refine.refine_solve``).  The default ``None`` does
                 so when the factor carries recorded perturbations or a
                 diagonal shift, so a perturbed factor still solves the
                 original system to full precision.
        """
        if refine is None:
            refine = (self.guard_report is not None
                      and self.guard_report.needs_refine
                      and self.guard_A is not None)
        if refine:
            if self.guard_A is None:
                raise ValueError(
                    "refined solve needs the original matrix; this factor "
                    "carries no guard_A (factor with guard= to record it)"
                )
            from repro_torch.core.refine import refine_solve
            x, hist = refine_solve(self, self.guard_A, b,
                                   backend=backend, engine=engine)
            if self.guard_report is not None:
                self.guard_report.ir_history.append(hist)
            return x
        if backend == "device":
            return self.solve_device(b, engine=engine)
        if backend != "host":
            raise ValueError(f"unknown backend {backend!r} (want 'host' or 'device')")
        sym = self.sym
        y = np.asarray(b, dtype=np.float64)[sym.perm].copy()
        squeeze = y.ndim == 1
        if squeeze:
            y = y[:, None]
        # forward: L z = Pb
        for s in range(sym.nsuper):
            f = int(sym.super_ptr[s])
            w = sym.width(s)
            P = self.panels[s]
            y[f:f + w] = sla.solve_triangular(P[:w, :w], y[f:f + w], lower=True)
            t = sym.rows[s][w:]
            if t.shape[0]:
                y[t] -= P[w:] @ y[f:f + w]
        # backward: L^T x = z
        for s in range(sym.nsuper - 1, -1, -1):
            f = int(sym.super_ptr[s])
            w = sym.width(s)
            P = self.panels[s]
            t = sym.rows[s][w:]
            rhs = y[f:f + w]
            if t.shape[0]:
                rhs = rhs - P[w:].T @ y[t]
            y[f:f + w] = sla.solve_triangular(P[:w, :w].T, rhs, lower=False)
        x = np.empty_like(y)
        x[sym.perm] = y
        return x[:, 0] if squeeze else x

    def solve_device(self, b: np.ndarray, *, engine=None) -> np.ndarray:
        """Level-scheduled batched solve on the device (see
        repro_torch.core.device_store.device_solve).  Stages the factor on
        first use when it is not already device-resident."""
        from repro_torch.core.device_store import DevicePanelStore, device_solve

        if self.dstore is None:
            if self.store is None:
                raise ValueError(
                    "device solve needs PanelStore-backed panels; this factor "
                    "was built without flat storage"
                )
            if engine is None:
                engine = self.engine
            if engine is None:
                from repro_torch.core.engines import DeviceEngine
                engine = DeviceEngine()
            sched = cached_schedule(self.sym, bucket="batch")
            self.dstore = DevicePanelStore(
                engine, self.sym, sched, self.store.storage, factored=True
            )
        return device_solve(self.dstore, b)


def _fill_panels(sym: SymbolicFactor, Aperm: sp.csc_matrix, panels: list) -> None:
    """Scatter the (permuted) matrix into zeroed supernode panels (lower part)."""
    Ap, Ai, Ax = Aperm.indptr, Aperm.indices, Aperm.data
    for s in range(sym.nsuper):
        f = int(sym.super_ptr[s])
        w = sym.width(s)
        r = sym.rows[s]
        P = panels[s]
        for c in range(w):
            j = f + c
            lo, hi = Ap[j], Ap[j + 1]
            rows_j = Ai[lo:hi]
            keep = rows_j >= j
            pos = np.searchsorted(r, rows_j[keep])
            P[pos, c] = Ax[lo:hi][keep]


def init_panels(sym: SymbolicFactor, Aperm: sp.csc_matrix) -> list:
    panels = [
        np.zeros((sym.rows[s].shape[0], sym.width(s)), dtype=np.float64)
        for s in range(sym.nsuper)
    ]
    _fill_panels(sym, Aperm, panels)
    return panels


class PanelStore:
    """All supernode panels in ONE flat float64 array.

    ``panels[s]`` is a C-contiguous *view* into ``storage`` (panel ``s``
    occupies ``storage[offs[s]:offs[s+1]]``, plus one trailing trash cell of
    the scatter plan).  ``storage`` lets callers wrap an existing flat array
    without copying.
    """

    def __init__(self, sym: SymbolicFactor, storage: np.ndarray | None = None):
        self.plan = scatter_plan(sym)
        if storage is None:
            storage = np.zeros(self.plan.storage_cells, dtype=np.float64)
        self.storage = storage
        offs = self.plan.offs
        self.panels = [
            self.storage[offs[s]:offs[s + 1]].reshape(
                sym.rows[s].shape[0], sym.width(s)
            )
            for s in range(sym.nsuper)
        ]

    def scatter(self, s: int, U: np.ndarray) -> None:
        """Apply supernode s's update matrix to every ancestor at once.
        Destinations are unique (plus the don't-care trash cell), so plain
        fancy indexing is exact."""
        dst = self.plan.dst[s]
        if dst.shape[0]:
            self.storage[dst] -= U.ravel()


def init_panel_store(sym: SymbolicFactor, Aperm: sp.csc_matrix) -> PanelStore:
    store = PanelStore(sym)
    _fill_panels(sym, Aperm, store.panels)
    return store


def _pick_engine(engine, device_engine, policy, sym, s, stats):
    if device_engine is not None and policy is not None and policy.on_device(sym, s):
        stats["supernodes_on_device"] += 1
        return device_engine
    return engine


# ---------------------------------------------------------------------------
# RL
# ---------------------------------------------------------------------------
def factorize_rl(
    sym: SymbolicFactor,
    Aperm: sp.csc_matrix,
    *,
    engine=None,
    device_engine=None,
    policy: OffloadPolicy | None = None,
) -> CholeskyFactor:
    """The paper's RL loop, one supernode at a time.  Without a device
    engine it is the host-only baseline."""
    engine = engine or HostEngine()
    store = init_panel_store(sym, Aperm)
    panels = store.panels
    stats = {"method": "rl", "supernodes_on_device": 0, "supernodes_total": sym.nsuper}

    for s in range(sym.nsuper):
        w = sym.width(s)
        eng = _pick_engine(engine, device_engine, policy, sym, s, stats)
        h = eng.stage(panels[s], w)          # transfer 1: CPU -> device
        eng.factor(h)                        # POTRF + TRSM
        out = eng.read_panel(h)              # transfer 2 (synchronous)
        if out is not panels[s]:             # HostEngine factors in place
            panels[s][...] = out
        if sym.rows[s].shape[0] == w:
            eng.release(h)
            continue
        U = np.asarray(eng.syrk_tail(h))     # SYRK; transfer 3: U back to CPU
        eng.release(h)
        # assembly on the host, as in the paper — one vectorized scatter per
        # supernode through the precomputed plan
        store.scatter(s, U)
    if device_engine is not None:
        device_engine.flush()
    return CholeskyFactor(sym=sym, panels=panels, stats=stats, store=store,
                          engine=device_engine)


# ---------------------------------------------------------------------------
# level-scheduled batched execution (see repro_torch.core.schedule)
# ---------------------------------------------------------------------------
def factorize_levels(
    sym: SymbolicFactor,
    Aperm: sp.csc_matrix,
    *,
    engine=None,
    device_engine=None,
    policy: OffloadPolicy | None = None,
    max_batch: int = 256,
    assembly: str = "auto",
    staging: str | None = None,
    guard: str | None = None,
    guard_thr: float = 0.0,
    guard_clamp: bool = False,
) -> CholeskyFactor:
    """Level-scheduled batched right-looking factorization.

    Supernodes are processed level by level up the supernodal etree (each
    level is an antichain), and each level's same-bucket supernodes go
    through the engines' batched protocol:

        hb = eng.stage_batch(panels, ws)   # ONE transfer per (level, bucket)
        eng.factor_batch(hb)               # ONE fused POTRF+TRSM+SYRK call
        eng.read_panels_batch(hb)          # ONE bulk read-back
        eng.syrk_tail_batch(hb)            # ONE bulk read-back of updates

    with the supernodes ``policy`` keeps on the host going through
    ``engine``, and assembly (the scatter plan) on the host.

    assembly  'auto'   — fully device-resident (``_factorize_levels_device``)
                         when a device engine takes every supernode (a zero
                         offload threshold); host assembly otherwise
              'host'   — always assemble on the host
              'device' — force the device-resident path (requires a device
                         engine; the offload policy is ignored)
    staging   device-resident path only: 'async' (default) or 'sync'
    guard     device-resident path only: 'raise' or 'perturb' runs every
              group through the guarded kernel (``guard_thr`` its clamp
              threshold, applied when ``guard_clamp``) and attaches the
              reduced ``GuardReport``; the host and mixed paths raise
              ValueError, as the reference's do
    """
    if assembly not in ("auto", "host", "device"):
        raise ValueError(
            f"unknown assembly {assembly!r} (want 'auto', 'host', or 'device')"
        )
    if assembly == "device" and device_engine is None:
        raise ValueError("assembly='device' requires a device engine")
    if device_engine is not None and assembly != "host" and (
        assembly == "device"
        or (policy is not None and policy.threshold == 0)
    ):
        return _factorize_levels_device(
            sym, Aperm, device_engine, max_batch=max_batch, staging=staging,
            guard=guard, guard_thr=guard_thr, guard_clamp=guard_clamp,
        )
    if guard is not None:
        raise ValueError(
            "guarded factorization requires the fully-offloaded "
            "device-resident path (device engine + full offload, or "
            "assembly='device'); the host/mixed paths detect breakdown "
            "through numpy's LinAlgError instead"
        )
    if staging is not None:
        raise ValueError(
            "staging applies only to the device-resident path (full offload "
            "or assembly='device')"
        )
    engine = engine or HostEngine()
    store = init_panel_store(sym, Aperm)
    panels = store.panels
    sched = cached_schedule(sym, max_batch=max_batch)
    stats = {
        "method": "levels",
        "assembly": "host",
        "supernodes_on_device": 0,
        "supernodes_total": sym.nsuper,
        "schedule": sched.batch_stats(),
        "level_stats": [],
    }

    for lvl, lgroups in enumerate(sched.groups):
        lrec = {"level": lvl, "supernodes": 0, "batches": 0, "max_batch": 0,
                "on_device": 0}
        for bg in lgroups:
            if device_engine is not None and policy is not None:
                on_dev = np.array([policy.on_device(sym, int(s)) for s in bg.ids])
            else:
                on_dev = np.zeros(bg.ids.shape[0], dtype=bool)
            for eng, ids in ((device_engine, bg.ids[on_dev]),
                             (engine, bg.ids[~on_dev])):
                if ids.shape[0] == 0:
                    continue
                if eng is device_engine:
                    stats["supernodes_on_device"] += int(ids.shape[0])
                    lrec["on_device"] += int(ids.shape[0])
                hb = eng.stage_batch(
                    [panels[int(s)] for s in ids],
                    [sym.width(int(s)) for s in ids],
                )
                eng.factor_batch(hb)
                outs = eng.read_panels_batch(hb)
                us = eng.syrk_tail_batch(hb)
                eng.release_batch(hb)
                for s, out, U in zip(ids, outs, us):
                    s = int(s)
                    if out is not panels[s]:
                        panels[s][...] = out
                    if U is not None:
                        store.scatter(s, U)
                lrec["batches"] += 1
                lrec["max_batch"] = max(lrec["max_batch"], int(ids.shape[0]))
                lrec["supernodes"] += int(ids.shape[0])
        stats["level_stats"].append(lrec)
    if device_engine is not None:
        device_engine.flush()
    return CholeskyFactor(sym=sym, panels=panels, stats=stats, store=store,
                          engine=device_engine)


def _factorize_levels_device(
    sym: SymbolicFactor,
    Aperm: sp.csc_matrix | None,
    device_engine,
    *,
    max_batch: int = 256,
    staging: str | None = None,
    store: PanelStore | None = None,
    guard: str | None = None,
    guard_thr: float = 0.0,
    guard_clamp: bool = False,
    bucket: str | None = None,
) -> CholeskyFactor:
    """Fully device-resident level-scheduled factorization: each (level x
    bucket) group is ONE fused dispatch, and with ``staging='async'`` (the
    default) level k+1's packed storage chunk is uploaded before level k is
    dispatched, so transfers overlap compute.

    ``store`` hands in a pre-filled PanelStore (the plan cache's vectorized
    fill), so ``Aperm`` may be None.  ``guard`` ('raise' or 'perturb') runs
    the guarded kernel and reduces its status into ``guard_report``.

    ``bucket`` names the schedule family; None picks the reference's: the
    coarse power-of-two ``"fused"`` one with fused groups (the fused kernel
    masks pad lanes, identity slabs and beyond-tail SYRK tiles, and its
    plain version keeps the same masked semantics, so the card and the CPU
    run the same plan), the fine ``"batch"`` one for the three-dispatch
    oracle of an engine without fused groups.  ``bucket="fused"`` runs the
    oracle on the one-dispatch path's own schedule, where the two agree bit
    for bit; on ``"batch"`` the other grouping of the prefix sums moves the
    factor by rounding at the scale of their running totals.

    Its phases are spans (``core/spans.py``): ``factor.fill``,
    ``factor.stage`` (holding ``stage.index`` and level 0's
    ``stage.chunk``), ``factor.levels`` (the later levels' ``stage.chunk``
    and the group dispatches), ``factor.read_back`` (``read_back.copy``,
    ``read_back.scatter``), then ``guard.report``.  None synchronises the
    device, so ``read_back.copy`` also waits for the levels' device
    work."""
    from repro_torch.core.device_store import DevicePanelStore

    device_engine.reset_events()  # one event log per factorization
    if store is None:
        with span("factor.fill"):
            store = init_panel_store(sym, Aperm)
    if bucket is None:
        bucket = "fused" if device_engine.fused_groups else "batch"
    sched = cached_schedule(sym, max_batch=max_batch, bucket=bucket)
    with span("factor.stage"):
        dstore = DevicePanelStore(device_engine, sym, sched, store.storage,
                                  staging=staging, guard=guard is not None,
                                  guard_thr=guard_thr,
                                  guard_clamp=guard_clamp)
    stats = {
        "method": "levels",
        "assembly": "device",
        "staging": dstore.staging,
        "bucket": bucket,
        "dispatches_per_group": 1 if dstore.fused else 3,
        "supernodes_on_device": sym.nsuper,
        "supernodes_total": sym.nsuper,
        "schedule": sched.batch_stats(),
        "level_stats": [],
    }
    with span("factor.levels"):
        for lvl, lgroups in enumerate(sched.groups):
            # double buffering: issue the next level's chunk upload BEFORE
            # this level's dispatches
            dstore.prefetch_level(lvl + 1)
            lrec = {"level": lvl, "supernodes": 0, "batches": 0,
                    "max_batch": 0, "on_device": 0}
            for gi, bg in enumerate(lgroups):
                dstore.assemble_group(lvl, gi)
                nb = int(bg.ids.shape[0])
                lrec["batches"] += 1
                lrec["supernodes"] += nb
                lrec["on_device"] += nb
                lrec["max_batch"] = max(lrec["max_batch"], nb)
            stats["level_stats"].append(lrec)
    with span("factor.read_back"):
        dstore.read_into(store.storage)  # ONE bulk factor read-back
        device_engine.flush()
    report = None
    if guard is not None:
        with span("guard.report"):
            report = _reduce_guard(sym, sched, dstore.guard_status(),
                                   mode=guard, thr=guard_thr)
        stats["guard"] = guard
    return CholeskyFactor(
        sym=sym, panels=store.panels, stats=stats, store=store, dstore=dstore,
        engine=device_engine, guard_report=report,
    )


def _reduce_guard(sym, sched, status_groups, *, mode: str, thr: float):
    """Reduce the per-lane kernel status rows of one factorization into a
    GuardReport (the reference's ``numeric._reduce_guard``): zip each
    group's (Bp, 4) status block — (min d^2, n_clamped, nonfinite, clamp
    magnitude) per lane, pad lanes (inf, 0, 0, 0) — with the schedule's
    supernode ids, in (level, group, lane) = elimination order, so
    ``first_broken`` names the first supernode that actually broke."""
    from repro_torch.core.guard import GuardReport

    rep = GuardReport(guard=mode, n_supernodes=int(sym.nsuper),
                      perturb_thr=float(thr))
    it = iter(status_groups)
    mins: list = []
    for lvl, lgroups in enumerate(sched.groups):
        lvl_min = None
        for bg in lgroups:
            st = np.asarray(next(it), dtype=np.float64)
            ids = np.asarray(bg.ids)
            for j in range(int(ids.shape[0])):
                mind2, ncl, nf, mag = st[j]
                snode = int(ids[j])
                mins.append(mind2)
                if np.isfinite(mind2):
                    lvl_min = mind2 if lvl_min is None else min(lvl_min, mind2)
                clamped = ncl > 0
                if clamped:
                    rep.perturbations.append({
                        "supernode": snode, "level": lvl,
                        "min_pivot": float(mind2), "n_clamped": int(ncl),
                        "magnitude": float(mag),
                    })
                # broken = nonfinite panel, or a nonpositive/NaN pivot that no
                # clamp rescued (NaN fails the ``> 0`` comparison on purpose)
                if (nf > 0) or (not clamped and not (mind2 > 0)):
                    rep.broken.append({
                        "supernode": snode, "level": lvl,
                        "min_pivot": float(mind2),
                        "nonfinite": bool(nf > 0),
                    })
                    if rep.first_broken is None:
                        rep.first_broken = snode
                        rep.first_broken_level = lvl
        rep.level_min_pivots.append(
            (lvl, None if lvl_min is None else float(lvl_min))
        )
    arr = np.asarray(mins, dtype=np.float64)
    fin = arr[np.isfinite(arr)]
    if fin.size:
        rep.min_pivot = float(np.min(fin))
    elif arr.size and np.any(np.isnan(arr)):
        rep.min_pivot = float("nan")
    return rep


# ---------------------------------------------------------------------------
# multi-matrix batched factorization (one pattern, M value streams)
# ---------------------------------------------------------------------------
@dataclass
class BatchCholeskyFactor:
    """M factors of matrices sharing ONE sparsity pattern, made by one set
    of fused multi-matrix dispatches (see ``api.cholesky_many``).

    ``storage`` is the (M, cells) flat factor block; ``factor(i)`` wraps row
    i in panel views (a zero-copy CholeskyFactor, usable anywhere a
    single-matrix factor is).  ``solve`` runs all M right-hand sides
    through the same level-scheduled device dispatches against the
    still-resident factor."""
    sym: SymbolicFactor
    nmat: int
    storage: np.ndarray       # (M, storage_cells)
    stats: dict | None = None
    dstore: object | None = None
    guard_reports: list | None = None  # per-matrix GuardReport (guarded)
    guard_As: list | None = None       # per-matrix original A (perturb)
    _factors: list | None = None

    def factor(self, i: int) -> CholeskyFactor:
        """Zero-copy single-matrix view of factor ``i``."""
        if self._factors is None:
            self._factors = [None] * self.nmat
        f = self._factors[i]
        if f is None:
            store = PanelStore(self.sym, storage=self.storage[i])
            f = self._factors[i] = CholeskyFactor(
                sym=self.sym, panels=store.panels, stats=self.stats,
                store=store,
                engine=None if self.dstore is None else self.dstore.eng,
                guard_report=(self.guard_reports[i]
                              if self.guard_reports else None),
                guard_A=self.guard_As[i] if self.guard_As else None,
            )
        return f

    def solve(self, b):
        """Solve A_i x_i = b_i for all M systems at once: ``b`` is (M, n) or
        (M, n, nrhs), every substitution level ONE dispatch covering all
        matrices.  A resident ``b`` (a tensor on the engine's device) stays
        resident: zero transfers, a resident result."""
        from repro_torch.core.device_store import device_solve

        return device_solve(self.dstore, b)


def factorize_levels_device_many(
    sym: SymbolicFactor,
    storage: np.ndarray,
    device_engine,
    *,
    max_batch: int = 256,
    staging: str | None = None,
    guard: str | None = None,
    guard_thr: float = 0.0,
    guard_clamp: bool = False,
) -> BatchCholeskyFactor:
    """Factor M matrices sharing one pattern with ONE set of level-scheduled
    dispatches: ``storage`` is the (M, cells) pre-filled flat storage block
    (``CachedPlan.fill_storage`` per row), and every (level x bucket) group
    runs as a single ``fused_group_many`` dispatch whose kernel call stacks
    all M matrices' lanes.  Per-group dispatch overhead is paid once per
    group instead of once per (matrix, group).  Spans as
    ``_factorize_levels_device``: ``factor.stage``, ``factor.levels``,
    ``factor.read_back`` and their children, ``guard.report``."""
    from repro_torch.core.device_store import DevicePanelStore

    device_engine.reset_events()
    M = int(storage.shape[0])
    if not device_engine.fused_groups:
        raise ValueError("multi-matrix factorization requires fused groups")
    bucket = "fused"
    sched = cached_schedule(sym, max_batch=max_batch, bucket=bucket)
    with span("factor.stage"):
        dstore = DevicePanelStore(device_engine, sym, sched, storage,
                                  staging=staging, nmat=M,
                                  guard=guard is not None,
                                  guard_thr=guard_thr,
                                  guard_clamp=guard_clamp)
    stats = {
        "method": "levels_many",
        "assembly": "device",
        "staging": dstore.staging,
        "bucket": bucket,
        "nmat": M,
        "supernodes_on_device": sym.nsuper,
        "supernodes_total": sym.nsuper,
        "schedule": sched.batch_stats(),
    }
    with span("factor.levels"):
        for lvl, lgroups in enumerate(sched.groups):
            dstore.prefetch_level(lvl + 1)
            for gi in range(len(lgroups)):
                dstore.assemble_group(lvl, gi)
    with span("factor.read_back"):
        dstore.read_into(storage)  # ONE bulk read-back of all M factors
        device_engine.flush()
    reports = None
    if guard is not None:
        with span("guard.report"):
            stat = dstore.guard_status()
            reports = [
                _reduce_guard(sym, sched, [st[m] for st in stat],
                              mode=guard, thr=guard_thr)
                for m in range(M)
            ]
        stats["guard"] = guard
    return BatchCholeskyFactor(
        sym=sym, nmat=M, storage=storage, stats=stats, dstore=dstore,
        guard_reports=reports,
    )


# ---------------------------------------------------------------------------
# RLB
# ---------------------------------------------------------------------------
def factorize_rlb(
    sym: SymbolicFactor,
    Aperm: sp.csc_matrix,
    *,
    engine=None,
    device_engine=None,
    policy: OffloadPolicy | None = None,
    batch_transfers: bool = False,
) -> CholeskyFactor:
    """RLB.  With a device engine, ``batch_transfers=False`` is the paper's
    second version (one transfer + assembly per block update — low memory);
    ``batch_transfers=True`` is the first version (keep every block update on
    the device until the supernode is done, then transfer them all at once)."""
    engine = engine or HostEngine()
    store = init_panel_store(sym, Aperm)
    panels = store.panels
    stats = {
        "method": "rlb", "supernodes_on_device": 0,
        "supernodes_total": sym.nsuper, "blas_calls": 0,
    }

    for s in range(sym.nsuper):
        w = sym.width(s)
        eng = _pick_engine(engine, device_engine, policy, sym, s, stats)
        h = eng.stage(panels[s], w)
        eng.factor(h)
        out = eng.read_panel(h)
        if out is not panels[s]:  # in-place: panels are PanelStore views
            panels[s][...] = out
        t = sym.rows[s][w:]
        if not t.shape[0]:
            eng.release(h)
            continue
        blocks = supernode_blocks(sym, s)
        relmap = {u.anc: u for u in ancestor_updates(sym, s)}
        defer = batch_transfers and eng is not engine
        pending: list = []
        for bi, B in enumerate(blocks):
            a = B.anc
            nb = B.k1 - B.k0
            r0, c0 = B.row_pos0, B.col_off0
            S = eng.syrk_block(h, B.k0, B.k1)
            stats["blas_calls"] += 1
            if defer:
                pending.append(((a, r0, None, c0, nb, True), S))
            else:
                panels[a][r0:r0 + nb, c0:c0 + nb] -= np.tril(eng.fetch(S))
            for B2 in blocks[bi + 1:]:
                G = eng.gemm_block(h, B2.k0, B2.k1, B.k0, B.k1)
                stats["blas_calls"] += 1
                u = relmap[a]
                rpos = u.rel_rows[B2.k0 - u.k0: B2.k1 - u.k0]
                if defer:
                    pending.append(((a, None, rpos, c0, nb, False), G))
                else:
                    panels[a][rpos[:, None], np.arange(c0, c0 + nb)[None, :]] -= eng.fetch(G)
        eng.release(h)
        if pending:
            # paper's RLB version 1: one big transfer, then host assembly
            results = eng.gather(x for _, x in pending)
            for (tgt, _), R in zip(pending, results):
                a, r0, rpos, c0, nb, diag = tgt
                if diag:
                    panels[a][r0:r0 + nb, c0:c0 + nb] -= np.tril(R)
                else:
                    panels[a][rpos[:, None], np.arange(c0, c0 + nb)[None, :]] -= R
    if device_engine is not None:
        device_engine.flush()
    return CholeskyFactor(sym=sym, panels=panels, stats=stats, store=store,
                          engine=device_engine)

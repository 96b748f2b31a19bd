"""Numeric supernodal right-looking Cholesky, device-resident level path.

Port of the main path of ``src/repro/core/numeric.py``: ``PanelStore`` keeps
every supernode panel in ONE flat float64 array, ``_factorize_levels_device``
factors it level by level on the device (see
``repro_torch.core.device_store``) and reads it back once, and
``CholeskyFactor`` solves with the factor on the host (the paper's
per-supernode loop) or on the device (level-scheduled batched substitution
against the still-resident factor).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
from torch.profiler import record_function

from repro_torch.core.relind import scatter_plan
from repro_torch.core.schedule import cached_schedule
from repro_torch.core.symbolic import SymbolicFactor


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

    def solve(self, b: np.ndarray, *, backend: str = "host") -> np.ndarray:
        """Solve A x = b using P A P^T = L L^T.

        backend  'host' (per-supernode scipy loop, the paper's solve) or
                 'device' (level-scheduled batched substitution against the
                 device-resident factor the factorization left behind).
        """
        if backend == "device":
            return self.solve_device(b)
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

    def solve_device(self, b: np.ndarray) -> np.ndarray:
        """Level-scheduled batched solve on the device (see
        repro_torch.core.device_store.device_solve)."""
        from repro_torch.core.device_store import device_solve

        if self.dstore is None:
            raise ValueError(
                "device solve needs the device-resident factor of a device "
                "factorization; staging a host factor is not ported yet"
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


def init_panel_store(sym: SymbolicFactor, Aperm: sp.csc_matrix) -> PanelStore:
    store = PanelStore(sym)
    _fill_panels(sym, Aperm, store.panels)
    return store


def _factorize_levels_device(
    sym: SymbolicFactor,
    Aperm: sp.csc_matrix | None,
    device_engine,
    *,
    max_batch: int = 256,
    staging: str | None = None,
    store: PanelStore | None = None,
) -> CholeskyFactor:
    """Fully device-resident level-scheduled factorization: each (level x
    bucket) group is ONE fused dispatch, and with ``staging='async'`` (the
    default) level k+1's packed storage chunk is uploaded before level k is
    dispatched, so transfers overlap compute.

    The bucket family is the coarse power-of-two ``"fused"`` one: the fused
    kernel masks pad lanes, identity slabs and beyond-tail SYRK tiles, and
    its plain version keeps the same masked semantics, so the card and the
    CPU run the same plan.

    Its phases are ``torch.profiler`` ranges (``factor.fill``,
    ``factor.stage``, ``factor.levels``, ``factor.read_back``), cheap when
    no profiler runs.  None synchronises the device, so
    ``factor.read_back`` also waits for the levels' device work."""
    from repro_torch.core.device_store import DevicePanelStore

    device_engine.reset_events()  # one event log per factorization
    if store is None:
        with record_function("factor.fill"):
            store = init_panel_store(sym, Aperm)
    bucket = "fused"
    sched = cached_schedule(sym, max_batch=max_batch, bucket=bucket)
    with record_function("factor.stage"):
        dstore = DevicePanelStore(device_engine, sym, sched, store.storage,
                                  staging=staging)
    stats = {
        "method": "levels",
        "assembly": "device",
        "staging": dstore.staging,
        "bucket": bucket,
        "dispatches_per_group": 1,
        "supernodes_on_device": sym.nsuper,
        "supernodes_total": sym.nsuper,
        "schedule": sched.batch_stats(),
        "level_stats": [],
    }
    with record_function("factor.levels"):
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
    with record_function("factor.read_back"):
        dstore.read_into(store.storage)  # ONE bulk factor read-back
        device_engine.flush()
    return CholeskyFactor(
        sym=sym, panels=store.panels, stats=stats, store=store, dstore=dstore,
    )

"""Device-resident factorization state: the index plans and DevicePanelStore.

Port of ``src/repro/core/device_store.py``.  The host PanelStore keeps the
whole factor in ONE flat float64 array.  This module moves the numeric phase
onto the device: the index plan is staged once, each level's raw storage is
staged as one chunk, every (level x bucket) group — panel gather, update
application, fused POTRF+TRSM+SYRK, packing — runs as one engine dispatch,
and the finished factor comes back in one transfer: O(1) host<->device
transfers per factorization.  The device-resident factor then serves
``CholeskyFactor.solve(b, backend="device")`` without re-staging.

Scatter-free assembly (fan-in)
------------------------------
A panel's storage cells are read exactly once (when its own group is
gathered), and every update entry's destination is known symbolically.  So
update matrices go to a preallocated device *pool* (packed real entries, one
contiguous slice per group), and when a group is gathered its pending
contributions are applied by the prefix-sum trick: with the incoming pool
entries gathered in destination order, the per-cell sums are
``C[hi] - C[lo]`` of the running sum.  A segment sum recovered as a
difference of prefixes carries absolute error proportional to the running
total, not the segment, which costs about one digit of residual against
direct summation (the reference notes 4e-13 -> ~2e-12 on its suite).

Index plans
-----------
For each schedule BatchGroup the plan precomputes, host-side and cached on
the LevelSchedule (bit-identical to the reference's plan):

    cells (r,)        flat-storage index of each real panel cell, packed in
                      (lane, row, col) order
    src (n,)          pool position of every incoming update entry, sorted
                      by destination packed cell
    lo / hi (r,)      segment bounds of each packed cell's contributions
    gidx (Bp,Lp,Wp)   index into the zero/one-extended packed vector that
                      reproduces the stacked padded panel buffer (pad cells
                      -> the zero cell r, identity diagonals -> the one cell
                      r+1)
    ppack (r,)        position in the factored (Bp,Lp,Wp) buffer of each
                      real cell
    upack (n_out,)    position in the (Bp,mp,mp) update buffer of each real
                      lower-triangle update entry, in pool order
    cols (Bp,Wp)      solve: global RHS row of each supernode column
                      (pad -> the RHS trash row at index n)
    tails (Bp,mp)     solve: global RHS row of each tail row (pad -> trash)
    base              offset of this group's packed cells in the
                      concatenated device factor

Levels are antichains of the supernodal etree, so every contribution to a
group is in the pool before the group runs, and the level-scheduled
triangular solves are exact for the same reason.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import counters
from repro_torch.core.buckets import _bucket_batch
from repro_torch.core.relind import scatter_plan
from repro_torch.core.schedule import LevelSchedule
from repro_torch.core.symbolic import SymbolicFactor


@dataclass
class GroupIndices:
    """Host-side index arrays for one schedule BatchGroup (see module doc)."""
    level: int
    Lp: int
    Wp: int
    B: int
    Bp: int
    base: int
    off: int               # this group's slice start in the update pool
    lb: int                # slice start within the level's packed chunk
    cells: np.ndarray      # (r,)
    src: np.ndarray        # (n,)
    lo: np.ndarray         # (r,)
    hi: np.ndarray         # (r,)
    gidx: np.ndarray       # (Bp, Lp, Wp)
    ppack: np.ndarray      # (r,)
    upack: np.ndarray      # (n_out,)
    rows_arr: np.ndarray   # (Bp,) true row count per lane (pad lanes 0)
    ws_arr: np.ndarray     # (Bp,) true width per lane (pad lanes 0)
    cols: np.ndarray       # (Bp, Wp)
    tails: np.ndarray      # (Bp, Lp-Wp)


@dataclass
class DeviceGroupPlan:
    """All GroupIndices of a schedule plus the global layouts."""
    groups: list            # list[list[GroupIndices]], same shape as sched.groups
    cells_concat: np.ndarray  # (packed_total,) factor cell of every packed slot
    level_base: np.ndarray  # (n_levels+1,) packed-slot start of each level
    packed_total: int       # == total real factor cells
    pool_size: int          # total real update entries


def build_device_plan(sym: SymbolicFactor, sched: LevelSchedule) -> DeviceGroupPlan:
    """Precompute every group's index arrays (symbolic phase; O(padded factor
    cells + update entries))."""
    counters.bump("device_plan")
    plan = scatter_plan(sym)
    offs = plan.offs
    n = sym.n
    packed_total = int(offs[-1])
    # src entries index the update pool, which is usually LARGER than the
    # packed factor — size the index dtype for both
    pool_total = sum(
        m * (m + 1) // 2
        for m in (sym.rows[s].shape[0] - sym.width(s) for s in range(sym.nsuper))
    )
    idx_t = (np.int32
             if max(packed_total, pool_total) < np.iinfo(np.int32).max
             else np.int64)

    # pass 1: per-supernode placement (group id, packed base of its lane)
    flat_groups = [bg for lg in sched.groups for bg in lg]
    gid_of_super = np.empty(sym.nsuper, dtype=np.int64)
    packed_start = np.empty(sym.nsuper, dtype=np.int64)  # global packed base
    group_base = np.zeros(len(flat_groups) + 1, dtype=np.int64)
    pos = 0
    for gi, bg in enumerate(flat_groups):
        group_base[gi] = pos
        for s in bg.ids:
            s = int(s)
            gid_of_super[s] = gi
            packed_start[s] = pos
            pos += sym.rows[s].shape[0] * sym.width(s)
    group_base[-1] = pos
    assert pos == packed_total

    # pass 2: pool layout + every update entry's destination (packed slot)
    pool_off = np.zeros(len(flat_groups) + 1, dtype=np.int64)
    dest_gid: list = []
    dest_pos: list = []
    for gi, bg in enumerate(flat_groups):
        cnt = 0
        for s in bg.ids:
            s = int(s)
            w = sym.width(s)
            m = sym.rows[s].shape[0] - w
            if m == 0:
                continue
            il, jl = np.tril_indices(m)
            dcell = plan.dst[s].reshape(m, m)[il, jl].astype(np.int64)
            # destination supernode of each entry -> its packed slot
            a = np.searchsorted(offs, dcell, side="right") - 1
            dest_gid.append(gid_of_super[a])
            dest_pos.append(packed_start[a] + (dcell - offs[a]))
            cnt += il.shape[0]
        pool_off[gi + 1] = pool_off[gi] + cnt
    pool_size = int(pool_off[-1])
    dest_gid = np.concatenate(dest_gid) if dest_gid else np.empty(0, np.int64)
    dest_pos = np.concatenate(dest_pos) if dest_pos else np.empty(0, np.int64)
    # incoming entries of each group, sorted by destination packed slot
    order = np.lexsort((dest_pos, dest_gid))
    sorted_gid = dest_gid[order]
    sorted_pos = dest_pos[order]
    grp_lo = np.searchsorted(sorted_gid, np.arange(len(flat_groups)))
    grp_hi = np.searchsorted(sorted_gid, np.arange(len(flat_groups)), side="right")

    # pass 3: per-group index arrays
    out: list = []
    gi = 0
    cells_concat = np.empty(packed_total, dtype=np.int64)
    level_base = np.zeros(len(sched.groups) + 1, dtype=np.int64)
    for lvl_i, lgroups in enumerate(sched.groups):
        level_base[lvl_i] = group_base[gi]
        lvl_out = []
        for bg in lgroups:
            Lp, Wp = bg.Lp, bg.Wp
            mp = Lp - Wp
            B = int(bg.ids.shape[0])
            Bp = _bucket_batch(B)
            base = int(group_base[gi])
            r = int(group_base[gi + 1] - base)
            gidx = np.full((Bp, Lp, Wp), r, dtype=idx_t)      # r = the zero cell
            d = np.arange(Wp)
            gidx[B:, d, d] = r + 1                             # pad lanes: identity
            cols = np.full((Bp, Wp), n, dtype=idx_t)
            tails = np.full((Bp, mp), n, dtype=idx_t)
            cells = np.empty(r, dtype=idx_t)
            ppack = np.empty(r, dtype=idx_t)
            rows_arr = np.zeros(Bp, dtype=np.int32)  # pad lanes stay (0, 0):
            ws_arr = np.zeros(Bp, dtype=np.int32)    # the masked kernel skips them
            upacks = []
            p = 0
            for i, s in enumerate(bg.ids):
                s = int(s)
                w = sym.width(s)
                f = int(sym.super_ptr[s])
                rows = sym.rows[s]
                m = rows.shape[0] - w
                rows_arr[i] = rows.shape[0]
                ws_arr[i] = w
                sz = rows.shape[0] * w
                cells[p:p + sz] = offs[s] + np.arange(sz)
                # padded row of each real row: diag rows stay, tail rows jump
                # past the identity extension
                prow = np.concatenate(
                    [np.arange(w), np.arange(Wp, Wp + m)]
                )
                cgrid = np.arange(w)
                pp = ((i * Lp + prow)[:, None] * Wp + cgrid).ravel()
                ppack[p:p + sz] = pp
                gidx.reshape(-1)[pp] = p + np.arange(sz)
                dd = np.arange(w, Wp)
                gidx[i, dd, dd] = r + 1
                cols[i, :w] = f + np.arange(w)
                if m:
                    tails[i, :m] = rows[w:]
                    il, jl = np.tril_indices(m)
                    upacks.append(i * mp * mp + il * mp + jl)
                p += sz
            cells_concat[base:base + r] = cells
            upack = (np.concatenate(upacks).astype(idx_t)
                     if upacks else np.empty(0, dtype=idx_t))
            src = order[grp_lo[gi]:grp_hi[gi]].astype(idx_t)
            pp_in = sorted_pos[grp_lo[gi]:grp_hi[gi]] - base
            counts = np.bincount(pp_in, minlength=r)
            hi = np.cumsum(counts).astype(idx_t)
            lo = (hi - counts).astype(idx_t)
            lvl_out.append(GroupIndices(
                level=bg.level, Lp=Lp, Wp=Wp, B=B, Bp=Bp,
                base=base, off=int(pool_off[gi]),
                lb=int(base - level_base[bg.level]),
                cells=cells, src=src, lo=lo, hi=hi, gidx=gidx,
                ppack=ppack, upack=upack,
                rows_arr=rows_arr, ws_arr=ws_arr, cols=cols, tails=tails,
            ))
            gi += 1
        out.append(lvl_out)
    level_base[-1] = packed_total
    return DeviceGroupPlan(
        groups=out, cells_concat=cells_concat, level_base=level_base,
        packed_total=packed_total, pool_size=pool_size,
    )


def device_plan(sym: SymbolicFactor, sched: LevelSchedule) -> DeviceGroupPlan:
    """Cached accessor mirroring ``relind.scatter_plan``: built once per
    LevelSchedule (itself cached per SymbolicFactor), reused across
    factorizations and solves."""
    if sched.device_plan is None:
        sched.device_plan = build_device_plan(sym, sched)
    return sched.device_plan


class _DevGroup:
    """One group's index arrays as device tensors (int64 indices, int32
    lane extents), plus its solve buffers once materialized."""
    __slots__ = ("cells", "src", "lo", "hi", "gidx", "ppack", "upack",
                 "rows", "ws", "cols", "tails", "off", "base", "lb", "P",
                 "Dinv")

    def __init__(self, cells, src, lo, hi, gidx, ppack, upack, rows, ws,
                 cols, tails, off, base, lb):
        self.cells, self.src, self.lo, self.hi = cells, src, lo, hi
        self.gidx, self.ppack, self.upack = gidx, ppack, upack
        self.rows, self.ws = rows, ws
        self.cols, self.tails = cols, tails
        self.off, self.base, self.lb = off, base, lb
        self.P = None     # stacked padded factored panels (built at finalize)
        self.Dinv = None  # inverted diagonal blocks (built at finalize)


#: the index arrays every group uploads, in upload order (the fused dispatch
#: slices its level chunk and never indexes raw storage cells)
_KINDS = ("src", "lo", "hi", "gidx", "ppack", "upack", "rows_arr", "ws_arr",
          "cols", "tails")
#: the three-dispatch oracle's: it gathers from the whole staged storage
_ORACLE_KINDS = ("cells",) + _KINDS
#: the ones a store of an already-factored storage needs (the solve's)
_SOLVE_KINDS = ("gidx", "cols", "tails")


class DevicePanelStore:
    """The flat PanelStore factorization state, resident on the device.

    Construction uploads every group's index arrays in ONE transfer (sliced
    and reshaped on the device).  ``staging`` picks how the raw storage,
    packed in group (= level) order, reaches the device:

        'async'  per-level chunks, each sent by ``eng.put_async`` BEFORE the
                 previous level is dispatched (pinned memory, side stream),
                 so uploads overlap compute; the driver calls
                 ``prefetch_level(k + 1)`` before dispatching level k.
                 The default.
        'sync'   one upload of all levels at construction.

    With an engine of ``fused_groups=False`` a group runs as the
    reference's three dispatches (``gather_group`` from the whole staged
    storage, ``factor_group``, ``pack_group``): the oracle the one-dispatch
    group is held to.  It stages synchronously and has no guard and no
    multi-matrix layout, so those raise, as in the reference.

    ``assemble_group`` advances the factorization one (level, bucket)
    dispatch at a time with zero transfers; ``read_into`` brings the factor
    back in one transfer, and the packed factor stays resident for
    ``device_solve``.

    ``factored=True`` stages an already-factored host storage instead (a
    factor of the sequential or mixed paths, or one carried across from
    another package): only the solve's index arrays and the packed factor
    go up, in two transfers, and nothing is factored.

    ``nmat`` > 1 is the multi-matrix layout: ``host_storage`` is (nmat,
    cells), nmat value streams over ONE pattern; every value buffer
    (chunks, pool, packed factor) carries a leading matrix axis, the index
    plan is shared, and each group factors all matrices in one
    ``fused_group_many`` dispatch.

    ``guard`` runs every group through the guarded kernel (clamping at
    ``guard_thr`` when ``guard_clamp``); the per-group status blocks are
    concatenated onto the ONE factor read-back, so detection costs no
    transfer, and ``guard_status`` returns them.
    """

    def __init__(self, eng, sym: SymbolicFactor, sched: LevelSchedule,
                 host_storage: np.ndarray, *, factored: bool = False,
                 staging: str | None = None, nmat: int = 1,
                 guard: bool = False, guard_thr: float = 0.0,
                 guard_clamp: bool = False):
        self.eng, self.sym, self.sched = eng, sym, sched
        gp = device_plan(sym, sched)
        self.plan = gp
        self.nmat = int(nmat)
        self.guard = bool(guard)
        self.guard_thr = float(guard_thr)
        self.guard_clamp = bool(guard_clamp)
        self.fused = (not factored) and eng.fused_groups
        self._status: list = []
        self._status_host = None
        if self.guard and factored:
            raise ValueError("guard applies only to a store that factors")
        if factored and staging is not None:
            raise ValueError("staging applies only to a store that factors")
        if self.guard and not (factored or self.fused):
            raise ValueError(
                "guarded factorization needs fused groups (the "
                "three-dispatch fallback emits no status lanes)"
            )
        if self.nmat > 1 and not (factored or self.fused):
            raise ValueError(
                "multi-matrix factorization needs fused groups (the "
                "three-dispatch fallback has no multi-matrix programs)"
            )
        if staging is None:
            staging = "async" if self.fused else "sync"
        if staging not in ("async", "sync"):
            raise ValueError(f"unknown staging {staging!r} (want 'async' or 'sync')")
        if staging == "async" and not self.fused:
            raise ValueError(
                "staging='async' needs fused groups (the three-dispatch "
                "path gathers from the full staged storage)"
            )
        self.staging = staging
        kinds = (_SOLVE_KINDS if factored
                 else _KINDS if self.fused else _ORACLE_KINDS)
        parts = [getattr(g, k).ravel()
                 for lvl in gp.groups for g in lvl for k in kinds]
        flat = np.concatenate(parts) if parts else np.zeros(0, dtype=np.int32)
        dflat = eng.put(flat).long()
        empty = dflat[0:0]
        self.groups: list = []
        pos = 0
        for lvl in gp.groups:
            row = []
            for g in lvl:
                devs = {}
                for k in kinds:
                    a = getattr(g, k)
                    devs[k] = dflat[pos:pos + a.size].reshape(a.shape)
                    pos += a.size
                row.append(_DevGroup(
                    cells=devs.get("cells", empty),
                    src=devs.get("src", empty), lo=devs.get("lo", empty),
                    hi=devs.get("hi", empty), gidx=devs["gidx"],
                    ppack=devs.get("ppack", empty),
                    upack=devs.get("upack", empty),
                    rows=devs.get("rows_arr", empty).to(torch.int32),
                    ws=devs.get("ws_arr", empty).to(torch.int32),
                    cols=devs["cols"], tails=devs["tails"],
                    off=g.off, base=g.base, lb=g.lb,
                ))
            self.groups.append(row)
        self.factor_ext = None
        self._packed: list = []
        self._solve_ready = False
        # resident solve-layout indices, uploaded at the first solve
        self.trash = self._iperm = self._operm = None
        self._host_storage = None
        self._chunks: list = []
        self.storage0 = None
        lead = (self.nmat,) if self.nmat > 1 else ()
        if factored:
            # the factored panels, packed, plus the shared zero and one cells
            packed = np.empty(lead + (gp.packed_total + 2,))
            packed[..., :-2] = host_storage[..., gp.cells_concat]
            packed[..., -2:] = (0.0, 1.0)
            self.factor_ext = eng.put(packed)
            self.pool = None
            return
        self.pool = torch.zeros(lead + (gp.pool_size,), dtype=torch.float64,
                                device=eng.device)
        if not self.fused:
            self.storage0 = eng.put(host_storage)
            return
        lb = gp.level_base
        nlev = len(gp.groups)
        if staging == "sync":
            whole = eng.put(host_storage[..., gp.cells_concat])
            self._chunks = [whole[..., lb[l]:lb[l + 1]] for l in range(nlev)]
        else:
            # the level's host-side gather runs at prefetch time, while
            # earlier levels' dispatches are in flight
            self._host_storage = host_storage
            self._chunks = [None] * nlev
            self.prefetch_level(0)

    def prefetch_level(self, lvl: int) -> None:
        """Gather one level's packed-storage chunk and issue its asynchronous
        upload; logged to the engine's event list."""
        if (self.staging != "async" or lvl >= len(self._chunks)
                or self._chunks[lvl] is not None):
            return
        gp = self.plan
        cells = gp.cells_concat[gp.level_base[lvl]:gp.level_base[lvl + 1]]
        self._chunks[lvl] = self.eng.put_async(
            self._host_storage[..., cells])
        self.eng._event("upload", lvl)

    def _chunk(self, lvl: int) -> torch.Tensor:
        if self.staging == "sync":
            return self._chunks[lvl]
        if self._chunks[lvl] is None:
            self.prefetch_level(lvl)  # direct callers without a driver
        return self.eng.wait(self._chunks[lvl])

    def assemble_group(self, lvl: int, gi: int) -> None:
        """Factor one (level, bucket) group on the device: ONE dispatch with
        fused groups, three on the oracle path."""
        g = self.groups[lvl][gi]
        if not self.fused:
            eng = self.eng
            buf = eng.gather_group(self.storage0, self.pool, g)
            fp, u = eng.factor_group(buf, g.rows, g.ws)
            self._packed.append(eng.pack_group(fp, u, self.pool, g))
            return
        run = (self.eng.fused_group_many if self.nmat > 1
               else self.eng.fused_group)
        if self.guard:
            packed, st = run(self._chunk(lvl), self.pool, g, lvl, guard=True,
                             thr=self.guard_thr, clamp=self.guard_clamp)
            self._status.append(st)
        else:
            packed = run(self._chunk(lvl), self.pool, g, lvl)
        self._packed.append(packed)

    def finalize(self) -> None:
        """Concatenate the per-group packed factors (plus the shared zero and
        one cells) into the resident factor the solve reads."""
        if self.factor_ext is not None:
            return
        dev = self.eng.device
        tail = torch.tensor([0.0, 1.0], dtype=torch.float64, device=dev)
        if self.nmat > 1:
            tail = tail.expand(self.nmat, 2)
        self.factor_ext = torch.cat(self._packed + [tail], dim=-1)
        self._packed = []
        self.pool = self.storage0 = None
        self._chunks = []
        self._host_storage = None

    def ensure_solve_ready(self) -> None:
        """First device solve only: build P/Dinv for every group and upload
        the solve-layout indices in ONE transfer: the trash row of each
        matrix and the two permutations that stage and unstage a resident
        right-hand side (the reference's layout)."""
        if self._solve_ready:
            return
        self.finalize()
        self._materialize_panels()
        n, M = self.sym.n, self.nmat
        perm = self.sym.perm
        iperm_nat = np.empty(n, dtype=np.int64)
        iperm_nat[perm] = np.arange(n)
        stride = np.arange(M, dtype=np.int64) * (n + 1)
        # padded row (mi, i) sources natural row (mi, perm[i]); trash rows
        # source row 0 and are zeroed right after the staging gather
        iperm = (np.concatenate([perm, [0]])[None, :]
                 + (np.arange(M, dtype=np.int64) * n)[:, None]).ravel()
        iperm[(n + 1) * np.arange(M) + n] = 0
        operm = (iperm_nat[None, :] + stride[:, None]).ravel()
        trash = stride + n
        aux = self.eng.put(np.concatenate([trash, iperm, operm]))
        self.trash = aux[:M]
        self._iperm = aux[M:M + M * (n + 1)]
        self._operm = aux[M + M * (n + 1):]
        self._solve_ready = True

    def _materialize_panels(self) -> None:
        """Each group's stacked padded factored-panel buffer P (gidx rebased
        onto the concatenated factor: real cells shift by the group base,
        the zero/one cells map to the shared pair at its end) and its
        inverted diagonal blocks Dinv, one batched inversion per group."""
        total = self.plan.packed_total
        n, M = self.sym.n, self.nmat
        for lvl, lgroups in enumerate(self.plan.groups):
            for gi, g in enumerate(lgroups):
                dg = self.groups[lvl][gi]
                r = g.cells.shape[0]
                sgidx = torch.where(dg.gidx < r, dg.gidx + g.base,
                                    dg.gidx - r + total)
                if M > 1:
                    # the M factors stack into one (M*Bp, ...) batch; each
                    # matrix's RHS rows are their own (n+1) block, so lane
                    # targets shift by mi*(n+1) (pads land on its own trash)
                    Bp = dg.gidx.shape[0]
                    dg.P = self.factor_ext[:, sgidx].reshape(M * Bp, g.Lp,
                                                             g.Wp)
                    shift = (torch.arange(M, device=dg.cols.device)
                             * (n + 1))[:, None, None]
                    dg.cols = (dg.cols[None] + shift).reshape(M * Bp, -1)
                    dg.tails = (dg.tails[None] + shift).reshape(M * Bp, -1)
                else:
                    dg.P = self.factor_ext[sgidx]
                dg.Dinv = self.eng.invert_diag(dg.P)

    def read_into(self, host_storage: np.ndarray) -> None:
        """One bulk device->host transfer of the factored packed panels.  A
        guarded factorization concatenates the per-group status blocks onto
        the same transfer, so detection costs no extra transfer."""
        self.finalize()
        nf = self.factor_ext.shape[-1]
        if self._status:
            lead = (self.nmat,) if self.nmat > 1 else ()
            flat = [st.reshape(lead + (-1,)) for st in self._status]
            blob = self.eng.get(torch.cat([self.factor_ext] + flat, dim=-1))
            packed, self._status_host = blob[..., :nf], blob[..., nf:]
            self._status = []
        else:
            packed = self.eng.get(self.factor_ext)
        host_storage[..., self.plan.cells_concat] = packed[..., :-2]

    def guard_status(self):
        """Per-group host status blocks in (level, group) dispatch order:
        (Bp, 4) each, or (nmat, Bp, 4) in the multi-matrix layout (columns
        as ``kernels.fused.STATUS_COLS``).  Available after ``read_into``;
        None when the store was not guarded."""
        if self._status_host is None:
            return None
        out = []
        pos = 0
        for row in self.groups:
            for dg in row:
                Bp = dg.gidx.shape[0]
                k = Bp * 4
                blk = self._status_host[..., pos:pos + k]
                out.append(blk.reshape(blk.shape[:-1] + (Bp, 4)))
                pos += k
        return out


def _solve_levels(dstore: DevicePanelStore, dy: torch.Tensor) -> torch.Tensor:
    """Run the forward then backward substitution levels on a staged RHS."""
    eng, groups, trash = dstore.eng, dstore.groups, dstore.trash
    for lvl in range(len(groups)):                 # forward: L z = P b
        row = groups[lvl]
        dy = eng.solve_fwd_level(dy, trash,
                                 [g.P for g in row], [g.Dinv for g in row],
                                 [g.cols for g in row], [g.tails for g in row])
    for lvl in range(len(groups) - 1, -1, -1):     # backward: L^T x = z
        row = groups[lvl]
        dy = eng.solve_bwd_level(dy, trash,
                                 [g.P for g in row], [g.Dinv for g in row],
                                 [g.cols for g in row], [g.tails for g in row])
    return dy


def device_solve(dstore: DevicePanelStore, b):
    """Solve A x = b with the device-resident factor: level-scheduled batched
    forward and backward substitution.  Profiler ranges: ``solve.prepare``
    (first solve only: the diagonal-block inversions) and ``solve.levels``.

    A host ``b`` (numpy) costs one upload and one download.  A resident
    ``b`` (a torch tensor on the store's device) costs no transfer: it is
    permuted into the padded solve layout on the device (``stage_rhs``)
    and the solution comes back as a tensor on that device, so callers
    chain solves without touching the host.  ``b`` is (n,) or (n, k); with
    ``nmat`` > 1, (nmat, n) or (nmat, n, k), all matrices in the same
    dispatches."""
    with record_function("solve.prepare"):
        dstore.ensure_solve_ready()
    sym, eng, M = dstore.sym, dstore.eng, dstore.nmat
    n = sym.n
    lead = (M,) if M > 1 else ()
    if isinstance(b, torch.Tensor):
        if b.device.type != eng.device.type:
            raise ValueError(f"a resident b must be on {eng.device}, got "
                             f"{b.device}")
        squeeze = b.dim() == len(lead) + 1
        y = b[..., None] if squeeze else b
        if y.dim() != len(lead) + 2 or tuple(y.shape[:-1]) != lead + (n,):
            raise ValueError(f"b must be {lead + (n,)} or {lead + (n, 'k')}, "
                             f"got {tuple(b.shape)}")
        flat = y.to(torch.float64).reshape(M * n, y.shape[-1])
        with record_function("solve.levels"):
            dy = eng.stage_rhs(flat, dstore._iperm, dstore.trash)
            x = eng.unstage_rhs(_solve_levels(dstore, dy), dstore._operm)
        x = x.reshape(y.shape)
        return x[..., 0] if squeeze else x
    y = np.asarray(b, dtype=np.float64)
    squeeze = y.ndim == len(lead) + 1
    if squeeze:
        y = y[..., None]
    if y.ndim != len(lead) + 2 or y.shape[:-1] != lead + (n,):
        raise ValueError(f"b must be {lead + (n,)} or {lead + (n, 'k')} with "
                         f"n = {n}, got {np.shape(b)}")
    k = y.shape[-1]
    yp = np.zeros(lead + (n + 1, k))
    yp[..., :n, :] = y[..., sym.perm, :]
    with record_function("solve.levels"):
        z = eng.get(_solve_levels(dstore, eng.put(yp.reshape(-1, k))))
    z = z.reshape(lead + (n + 1, k))[..., :n, :]
    x = np.empty_like(z)
    x[..., sym.perm, :] = z
    return x[..., 0] if squeeze else x

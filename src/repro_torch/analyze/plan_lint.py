"""Pass 1 — plan lint: prove the precomputed index plans self-consistent
(port of ``src/repro/analyze/plan_lint.py``; the port's plans are the
reference's bit for bit, so the checks are too).

The numeric phase trusts five layers of precomputed index arithmetic
(ScatterPlan -> fill plan -> LevelSchedule -> DeviceGroupPlan -> CachedPlan)
and applies them with *unchecked* fancy indexing: a single out-of-bounds or
duplicated index silently corrupts the factor (or worse, stays in bounds and
corrupts a *different* panel).  This pass re-derives every index from the
symbolic factorization with independent (simple, slow) arithmetic and checks:

  * ScatterPlan   — panel offsets tile the storage; every strict-upper
                    update entry routes to the trash cell; every lower entry
                    is in bounds, unique within its update (the fancy-indexed
                    ``storage[dst] -= U`` contract), and lands on exactly the
                    (ancestor row, ancestor column) cell the symbolic
                    structure dictates;
  * fill plan     — in bounds, never the trash cell, each storage cell
                    filled at most once;
  * LevelSchedule — parents strictly above children, every ancestor
                    receiving updates scheduled strictly later (levels are
                    true antichains), every supernode in exactly one group
                    that its bucket actually fits;
  * DeviceGroupPlan — the packed factor covers every storage cell exactly
                    once (coverage + disjointness = the write-write race
                    detector for the prefix-sum segment assembly), the
                    update pool is produced and consumed exactly once per
                    slot, segment bounds map every pool slot to the packed
                    cell the scatter plan says it updates, and the padded
                    gather/pack index buffers reproduce the layout the
                    kernels assume.

All checks are pure host-side numpy over the plan arrays — the numeric
phase never runs.
"""
from __future__ import annotations

import numpy as np

from repro_torch.analyze.findings import Finding
from repro_torch.core.relind import scatter_plan
from repro_torch.core.schedule import BUCKET_FNS, supernode_levels

_P = "plan-lint"


def _err(code, loc, inv, detail=""):
    return Finding("error", _P, code, loc, inv, detail)


def _widths(sym) -> np.ndarray:
    sp_ = np.asarray(sym.super_ptr, dtype=np.int64)
    return sp_[1:] - sp_[:-1]


# ---------------------------------------------------------------------------
# ScatterPlan
# ---------------------------------------------------------------------------
def lint_scatter_plan(sym, plan=None, *, max_findings: int = 50) -> list:
    plan = plan if plan is not None else scatter_plan(sym)
    out: list = []
    offs = np.asarray(plan.offs, dtype=np.int64)
    trash = int(plan.trash)
    ws = _widths(sym)
    if offs.shape[0] != sym.nsuper + 1 or offs[0] != 0:
        out.append(_err("offs-shape", "offs",
                        "offs is (nsuper+1,) starting at 0"))
        return out
    sizes = np.array([sym.rows[s].shape[0] * int(ws[s])
                      for s in range(sym.nsuper)], dtype=np.int64)
    if not np.array_equal(np.diff(offs), sizes):
        bad = int(np.flatnonzero(np.diff(offs) != sizes)[0])
        out.append(_err("offs-size", f"supernode {bad}",
                        "offs[s+1]-offs[s] equals the panel cell count",
                        f"got {int(offs[bad + 1] - offs[bad])}, want {int(sizes[bad])}"))
    if trash != int(offs[-1]):
        out.append(_err("trash-cell", "trash",
                        "the trash cell sits one past the last panel",
                        f"trash={trash}, offs[-1]={int(offs[-1])}"))
    for s in range(sym.nsuper):
        if len(out) >= max_findings:
            out.append(Finding("info", _P, "truncated", "scatter plan",
                               "finding list truncated", f"first {max_findings} shown"))
            return out
        w = int(ws[s])
        rows = np.asarray(sym.rows[s], dtype=np.int64)
        m = rows.shape[0] - w
        D = np.asarray(plan.dst[s], dtype=np.int64)
        loc = f"supernode {s}"
        if D.shape[0] != m * m:
            out.append(_err("dst-shape", loc,
                            "dst[s] has one entry per update-matrix cell",
                            f"len {D.shape[0]}, want {m * m}"))
            continue
        if m == 0:
            continue
        D2 = D.reshape(m, m)
        iu = np.triu_indices(m, 1)
        if not np.all(D2[iu] == trash):
            k = int(np.flatnonzero(D2[iu] != trash)[0])
            out.append(_err(
                "upper-not-trash", loc,
                "strict-upper update entries route to the trash cell",
                f"entry ({int(iu[0][k])},{int(iu[1][k])}) -> {int(D2[iu][k])}",
            ))
        il, jl = np.tril_indices(m)
        low = D2[il, jl]
        oob = (low < 0) | (low >= trash)
        if oob.any():
            k = int(np.flatnonzero(oob)[0])
            out.append(_err(
                "scatter-oob", loc,
                "lower-triangle destinations index real panel storage",
                f"entry ({int(il[k])},{int(jl[k])}) -> {int(low[k])} "
                f"outside [0, {trash})",
            ))
            continue
        if np.unique(low).shape[0] != low.shape[0]:
            vals, cnt = np.unique(low, return_counts=True)
            out.append(_err(
                "scatter-dup", loc,
                "destinations are unique within one update (the "
                "fancy-indexed `storage[dst] -= U` contract)",
                f"cell {int(vals[cnt > 1][0])} written "
                f"{int(cnt.max())}x",
            ))
        # semantic re-derivation: decode each destination back to its
        # (ancestor, row, column) and compare with the tail-row structure
        t = rows[w:]
        a = np.searchsorted(offs, low, side="right") - 1
        q = low - offs[a]
        wa = ws[a]
        rpos = q // wa
        cof = q % wa
        gcol = np.asarray(sym.super_ptr, dtype=np.int64)[a] + cof
        if not np.array_equal(gcol, t[jl]):
            k = int(np.flatnonzero(gcol != t[jl])[0])
            out.append(_err(
                "dest-column", loc,
                "entry (i, j) lands in the column of tail row j",
                f"entry ({int(il[k])},{int(jl[k])}) hit column {int(gcol[k])}, "
                f"want {int(t[jl][k])}",
            ))
            continue
        ok_row = np.empty(low.shape[0], dtype=bool)
        for anc in np.unique(a):
            sel = a == anc
            ra = np.asarray(sym.rows[int(anc)], dtype=np.int64)
            pos = rpos[sel]
            ok_row[sel] = (pos < ra.shape[0]) & (ra[np.minimum(pos, ra.shape[0] - 1)] == t[il][sel])
        if not ok_row.all():
            k = int(np.flatnonzero(~ok_row)[0])
            out.append(_err(
                "dest-row", loc,
                "entry (i, j) lands in the ancestor row of tail row i",
                f"entry ({int(il[k])},{int(jl[k])}) hit ancestor {int(a[k])} "
                f"row-position {int(rpos[k])}, want row {int(t[il][k])}",
            ))
    return out


# ---------------------------------------------------------------------------
# fill plan
# ---------------------------------------------------------------------------
def lint_fill_plan(sym, fill_src, fill_dst, nnz: int) -> list:
    out: list = []
    plan = scatter_plan(sym)
    src = np.asarray(fill_src, dtype=np.int64)
    dst = np.asarray(fill_dst, dtype=np.int64)
    loc = "fill plan"
    if src.shape != dst.shape:
        out.append(_err("fill-shape", loc, "fill_src and fill_dst align",
                        f"{src.shape} vs {dst.shape}"))
        return out
    if src.size and (src.min() < 0 or src.max() >= nnz):
        out.append(_err("fill-src-oob", loc,
                        "fill sources index the canonical data array",
                        f"range [{int(src.min())}, {int(src.max())}] vs nnz={nnz}"))
    if dst.size and (dst.min() < 0 or dst.max() >= plan.trash):
        out.append(_err("fill-dst-oob", loc,
                        "fill destinations index real panel storage "
                        "(never the trash cell)",
                        f"range [{int(dst.min())}, {int(dst.max())}] vs "
                        f"storage [0, {int(plan.trash)})"))
    if np.unique(dst).shape[0] != dst.shape[0]:
        vals, cnt = np.unique(dst, return_counts=True)
        out.append(_err("fill-dup", loc,
                        "each storage cell is filled at most once",
                        f"cell {int(vals[cnt > 1][0])} filled {int(cnt.max())}x"))
    return out


# ---------------------------------------------------------------------------
# LevelSchedule
# ---------------------------------------------------------------------------
def lint_schedule(sym, sched, *, bucket: str | None = None) -> list:
    out: list = []
    lev = np.asarray(sched.levels, dtype=np.int64)
    if lev.shape[0] != sym.nsuper:
        return [_err("levels-shape", "schedule",
                     "one level per supernode",
                     f"{lev.shape[0]} levels, {sym.nsuper} supernodes")]
    sparent = np.asarray(sym.sparent, dtype=np.int64)
    has_p = sparent >= 0
    bad = has_p & (lev[np.maximum(sparent, 0)] <= lev)
    if bad.any():
        s = int(np.flatnonzero(bad)[0])
        out.append(_err("parent-level", f"supernode {s}",
                        "parents sit strictly above their children",
                        f"level {int(lev[s])} vs parent {int(sparent[s])} "
                        f"at level {int(lev[sparent[s]])}"))
    # independently recomputed levels must agree (the antichain witness)
    ref = supernode_levels(sparent)
    if not np.array_equal(lev, ref):
        s = int(np.flatnonzero(lev != ref)[0])
        out.append(_err("levels-value", f"supernode {s}",
                        "levels equal the etree leaf-depth recurrence",
                        f"got {int(lev[s])}, want {int(ref[s])}"))
    # every ancestor receiving updates is scheduled strictly later
    ws = _widths(sym)
    snode = np.asarray(sym.snode, dtype=np.int64)
    for s in range(sym.nsuper):
        t = np.asarray(sym.rows[s][int(ws[s]):], dtype=np.int64)
        if t.size == 0:
            continue
        ancs = np.unique(snode[t])
        late = lev[ancs] <= lev[s]
        if late.any():
            a = int(ancs[late][0])
            out.append(_err(
                "ancestor-order", f"supernode {s}",
                "every ancestor update target runs at a strictly later "
                "level (levels are antichains)",
                f"updates supernode {a} at level {int(lev[a])}, own level "
                f"{int(lev[s])}",
            ))
            break
    # coverage: each supernode in exactly one group, level tag consistent,
    # bucket large enough for the member
    seen = np.zeros(sym.nsuper, dtype=np.int64)
    bucket_fn = BUCKET_FNS.get(bucket) if bucket else None
    for li, lgroups in enumerate(sched.groups):
        for gi, bg in enumerate(lgroups):
            loc = f"level {li} group {gi}"
            if bg.level != li:
                out.append(_err("group-level", loc,
                                "groups are filed under their own level",
                                f"tagged level {bg.level}"))
            ids = np.asarray(bg.ids, dtype=np.int64)
            if ids.size and (ids.min() < 0 or ids.max() >= sym.nsuper):
                out.append(_err("group-ids-oob", loc,
                                "group members are supernode ids"))
                continue
            seen[ids] += 1
            if not np.all(lev[ids] == li):
                s = int(ids[lev[ids] != li][0])
                out.append(_err("member-level", loc,
                                "members belong to the group's level",
                                f"supernode {s} has level {int(lev[s])}"))
            for s in ids:
                s = int(s)
                w = int(ws[s])
                m = sym.rows[s].shape[0] - w
                if bg.Wp < w or bg.Lp < bg.Wp + m:
                    out.append(_err(
                        "bucket-fit", loc,
                        "the bucket holds every member's padded panel",
                        f"supernode {s} ({w + m}x{w}) in bucket "
                        f"({bg.Lp}, {bg.Wp})",
                    ))
                    break
            if bucket_fn is not None:
                for s in ids:
                    s = int(s)
                    want = bucket_fn(int(sym.rows[s].shape[0]), int(ws[s]))
                    if (bg.Lp, bg.Wp) != want:
                        out.append(Finding(
                            "warning", _P, "bucket-family", loc,
                            f"members bucket to the declared "
                            f"'{bucket}' family shape",
                            f"supernode {s} wants {want}, "
                            f"group is ({bg.Lp}, {bg.Wp})",
                        ))
                        break
    if not np.all(seen == 1):
        s = int(np.flatnonzero(seen != 1)[0])
        out.append(_err("schedule-coverage", f"supernode {s}",
                        "every supernode is scheduled exactly once",
                        f"scheduled {int(seen[s])}x"))
    return out


# ---------------------------------------------------------------------------
# DeviceGroupPlan
# ---------------------------------------------------------------------------
def _pool_destinations(sym, sched, gp) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Re-derive, for every update-pool slot, (a) its destination cell in the
    packed factor and (b) its producer group — straight from the scatter
    plan, independent of the src/lo/hi arrays under test.  Also returns the
    per-group pool offsets (walk order)."""
    plan = scatter_plan(sym)
    offs = np.asarray(plan.offs, dtype=np.int64)
    ws = _widths(sym)
    flat = [bg for lg in sched.groups for bg in lg]
    packed_start = np.empty(sym.nsuper, dtype=np.int64)
    pos = 0
    for bg in flat:
        for s in bg.ids:
            s = int(s)
            packed_start[s] = pos
            pos += sym.rows[s].shape[0] * int(ws[s])
    dest = []
    producer = []
    pool_off = np.zeros(len(flat) + 1, dtype=np.int64)
    for gi, bg in enumerate(flat):
        cnt = 0
        for s in bg.ids:
            s = int(s)
            m = sym.rows[s].shape[0] - int(ws[s])
            if m == 0:
                continue
            il, jl = np.tril_indices(m)
            dcell = np.asarray(plan.dst[s], dtype=np.int64).reshape(m, m)[il, jl]
            a = np.searchsorted(offs, dcell, side="right") - 1
            dest.append(packed_start[a] + (dcell - offs[a]))
            producer.append(np.full(il.shape[0], gi, dtype=np.int64))
            cnt += il.shape[0]
        pool_off[gi + 1] = pool_off[gi] + cnt
    dest = np.concatenate(dest) if dest else np.empty(0, np.int64)
    producer = np.concatenate(producer) if producer else np.empty(0, np.int64)
    return dest, producer, pool_off


def lint_device_plan(sym, sched, gp=None) -> list:
    from repro_torch.core.device_store import device_plan

    gp = gp if gp is not None else device_plan(sym, sched)
    out: list = []
    plan = scatter_plan(sym)
    ws = _widths(sym)
    n = sym.n
    total = int(gp.packed_total)
    cells = np.asarray(gp.cells_concat, dtype=np.int64)
    loc = "device plan"
    if total != int(plan.trash) or cells.shape[0] != total:
        out.append(_err("pack-size", loc,
                        "the packed factor holds every real storage cell",
                        f"packed_total={total}, storage={int(plan.trash)}, "
                        f"cells_concat len {cells.shape[0]}"))
        return out
    if not np.array_equal(np.sort(cells), np.arange(total)):
        vals, cnt = np.unique(cells, return_counts=True)
        dup = vals[cnt > 1]
        detail = (f"cell {int(dup[0])} packed {int(cnt[cnt > 1][0])}x" if dup.size
                  else "some storage cells never packed")
        out.append(_err("pack-coverage", loc,
                        "every factor cell is packed exactly once "
                        "(coverage + disjointness: no write-write races "
                        "in the packed factor)", detail))
    lb_ = np.asarray(gp.level_base, dtype=np.int64)
    if lb_.shape[0] != len(gp.groups) + 1 or lb_[0] != 0 or lb_[-1] != total \
            or np.any(np.diff(lb_) < 0):
        out.append(_err("level-base", loc,
                        "level bases partition the packed factor in order"))
    # re-derive every pool slot's destination + producer from the scatter plan
    dest, producer, pool_off = _pool_destinations(sym, sched, gp)
    if int(gp.pool_size) != dest.shape[0]:
        out.append(_err("pool-size", loc,
                        "the pool holds every real update entry",
                        f"pool_size={int(gp.pool_size)}, derived {dest.shape[0]}"))
        return out
    flat = [(li, gi, g) for li, lg in enumerate(gp.groups)
            for gi, g in enumerate(lg)]
    src_all = []
    pos = 0
    for k, (li, gi, g) in enumerate(flat):
        loc = f"level {li} group {gi}"
        r = int(np.asarray(g.cells).shape[0])
        if int(g.base) != pos:
            out.append(_err("group-base", loc,
                            "groups pack back to back in walk order",
                            f"base {int(g.base)}, want {pos}"))
        if int(g.lb) != int(g.base) - int(lb_[li]):
            out.append(_err("chunk-offset", loc,
                            "lb is the group's offset inside its level chunk",
                            f"lb {int(g.lb)}, want {int(g.base) - int(lb_[li])}"))
        if int(g.off) != int(pool_off[k]):
            out.append(_err("pool-offset", loc,
                            "pool slices tile the pool in walk order",
                            f"off {int(g.off)}, want {int(pool_off[k])}"))
        pos += r
        src = np.asarray(g.src, dtype=np.int64)
        lo = np.asarray(g.lo, dtype=np.int64)
        hi = np.asarray(g.hi, dtype=np.int64)
        src_all.append(src)
        if src.size and (src.min() < 0 or src.max() >= dest.shape[0]):
            out.append(_err("src-oob", loc,
                            "incoming-update indices stay inside the pool",
                            f"range [{int(src.min())}, {int(src.max())}] vs "
                            f"pool {dest.shape[0]}"))
            continue
        n_in = src.shape[0]
        seg_ok = (lo.shape == (r,) and hi.shape == (r,)
                  and (r == 0 or (lo[0] == 0 and hi[-1] == n_in))
                  and np.all(hi >= lo) and np.array_equal(lo[1:], hi[:-1]))
        if not seg_ok:
            out.append(_err("segment-bounds", loc,
                            "lo/hi tile [0, n_in) contiguously per packed cell"))
            continue
        # the load-bearing check: slot k of segment i must be an update entry
        # whose scatter-plan destination IS packed cell base+i
        want = int(g.base) + np.repeat(np.arange(r), hi - lo)
        if not np.array_equal(dest[src], want):
            k_bad = int(np.flatnonzero(dest[src] != want)[0])
            out.append(_err(
                "segment-map", loc,
                "each segment gathers exactly the pool entries destined "
                "for its packed cell (wrong-cell assembly otherwise)",
                f"slot {k_bad}: pool entry {int(src[k_bad])} is destined for "
                f"packed cell {int(dest[src][k_bad])}, segment covers "
                f"{int(want[k_bad])}",
            ))
    # pool coverage: every produced entry consumed exactly once
    src_cat = (np.concatenate(src_all) if src_all else np.empty(0, np.int64))
    if not np.array_equal(np.sort(src_cat), np.arange(dest.shape[0])):
        vals, cnt = np.unique(src_cat, return_counts=True)
        dup = vals[cnt > 1] if vals.size else np.empty(0)
        detail = (f"pool slot {int(dup[0])} consumed {int(cnt[cnt > 1][0])}x"
                  if dup.size else "some pool slots never consumed (lost updates)")
        out.append(_err("pool-coverage", "device plan",
                        "every update entry is consumed exactly once",
                        detail))
    # per-group padded-layout buffers: re-derive gidx/ppack/cols/tails/extents
    for li, gi, g in flat:
        loc = f"level {li} group {gi}"
        bg = sched.groups[li][gi]
        Lp, Wp = bg.Lp, bg.Wp
        mp = Lp - Wp
        gidx = np.asarray(g.gidx, dtype=np.int64)
        r = int(np.asarray(g.cells).shape[0])
        Bp = gidx.shape[0]
        exp_gidx = np.full((Bp, Lp, Wp), r, dtype=np.int64)
        d = np.arange(Wp)
        exp_gidx[len(bg.ids):, d, d] = r + 1
        exp_cols = np.full((Bp, Wp), n, dtype=np.int64)
        exp_tails = np.full((Bp, mp), n, dtype=np.int64)
        exp_rows = np.zeros(Bp, dtype=np.int64)
        exp_ws = np.zeros(Bp, dtype=np.int64)
        exp_ppack = np.empty(r, dtype=np.int64)
        exp_cells = np.empty(r, dtype=np.int64)
        p = 0
        ok = True
        for i, s in enumerate(bg.ids):
            s = int(s)
            w = int(ws[s])
            rows = np.asarray(sym.rows[s], dtype=np.int64)
            m = rows.shape[0] - w
            if i >= Bp or p + rows.shape[0] * w > r:
                out.append(_err("group-shape", loc,
                                "lane/cell counts match the schedule group"))
                ok = False
                break
            exp_rows[i], exp_ws[i] = rows.shape[0], w
            sz = rows.shape[0] * w
            exp_cells[p:p + sz] = plan.offs[s] + np.arange(sz)
            prow = np.concatenate([np.arange(w), np.arange(Wp, Wp + m)])
            pp = ((i * Lp + prow)[:, None] * Wp + np.arange(w)).ravel()
            exp_ppack[p:p + sz] = pp
            exp_gidx.reshape(-1)[pp] = p + np.arange(sz)
            dd = np.arange(w, Wp)
            exp_gidx[i, dd, dd] = r + 1
            exp_cols[i, :w] = int(sym.super_ptr[s]) + np.arange(w)
            if m:
                exp_tails[i, :m] = rows[w:]
            p += sz
        if not ok:
            continue
        for name, got, want in (
            ("gidx", gidx, exp_gidx),
            ("ppack", np.asarray(g.ppack, dtype=np.int64), exp_ppack),
            ("cells", np.asarray(g.cells, dtype=np.int64), exp_cells),
            ("cols", np.asarray(g.cols, dtype=np.int64), exp_cols),
            ("tails", np.asarray(g.tails, dtype=np.int64), exp_tails),
            ("rows_arr", np.asarray(g.rows_arr, dtype=np.int64), exp_rows),
            ("ws_arr", np.asarray(g.ws_arr, dtype=np.int64), exp_ws),
        ):
            if got.shape != want.shape or not np.array_equal(got, want):
                out.append(_err(
                    f"{name}-mismatch", loc,
                    f"{name} reproduces the padded layout derived from "
                    "the symbolic structure",
                ))
                break
    return out


# ---------------------------------------------------------------------------
# orchestrator
# ---------------------------------------------------------------------------
def lint_plan_stack(sym, *, buckets=("fused",), max_batch: int = 256,
                    fill=None, nnz: int | None = None) -> list:
    """Run every plan-lint check over one symbolic factor: the scatter plan,
    one schedule + device plan per bucket family, and (when ``fill`` is a
    (fill_src, fill_dst) pair with ``nnz``) the fill plan."""
    from repro_torch.core.schedule import cached_schedule

    out = lint_scatter_plan(sym)
    for bucket in buckets:
        sched = cached_schedule(sym, max_batch=max_batch, bucket=bucket)
        out += lint_schedule(sym, sched, bucket=bucket)
        out += lint_device_plan(sym, sched)
    if fill is not None and nnz is not None:
        out += lint_fill_plan(sym, fill[0], fill[1], nnz)
    return out

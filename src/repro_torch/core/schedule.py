"""Level scheduling for the numeric phase: batch independent supernodes.

The supernodal elimination tree (``SymbolicFactor.sparent``) encodes every
numeric dependency of right-looking factorization: a supernode receives
updates only from its strict descendants (a descendant's tail rows are a
subset of the columns on its path to the root).  Assigning each supernode
the level

    level(s) = 0                      if s is a leaf
    level(s) = 1 + max(level(child))  otherwise

makes every level an *antichain*: no supernode in a level depends on another
in the same level, so all of them can be staged, factored, and update-matrix
SYRKed together.  This is the level-set idea used for sparse triangular
solves (Naumov) and task-parallel Cholesky (fan-both solvers), applied to
the paper's per-supernode offload loop.

Within a level, supernodes are grouped by their padded engine bucket
``(Lp, Wp)`` (see ``repro_torch.core.buckets``) so each group stacks into
one ``(batch, Lp, Wp)`` buffer and runs a single batched fused
POTRF+TRSM+SYRK program — collapsing O(nsuper) transfers and dispatches to
O(levels x buckets).  Groups are chunked to ``max_batch`` lanes and to a
cell budget (padded panel + update-matrix cells) so host/device buffers
stay bounded.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import counters
from repro_torch.core.buckets import (
    bucket_shape,
    bucket_shape_batch,
    bucket_shape_fused,
    syrk_tile,
)
from repro_torch.core.symbolic import SymbolicFactor

#: bucket functions selectable by ``build_schedule(..., bucket=...)``:
#: "seq" — the engines' staging bucket family (coarse; shared with the
#:         sequential offload path, exactly the PR 1 behaviour), used by the
#:         host-assembly batched path;
#: "batch" — the fine family for the device-resident path, where padding is
#:         pure wasted compute (see buckets.bucket_shape_batch);
#: "fused" — the coarse power-of-two family for the fused masked-kernel
#:         path, where pad lanes/slabs/tiles are skipped, not computed, so
#:         coarse buckets buy fewer compiles and bigger batches for free
#:         (see buckets.bucket_shape_fused).
BUCKET_FNS = {"seq": bucket_shape, "batch": bucket_shape_batch,
              "fused": bucket_shape_fused}


def supernode_levels(sparent: np.ndarray) -> np.ndarray:
    """Level of each supernode in the supernodal etree (leaves = 0).

    Relies on the topological property ``sparent[s] > s`` (validated by
    ``SymbolicFactor.validate``), so one ascending pass suffices.
    """
    ns = sparent.shape[0]
    lev = np.zeros(ns, dtype=np.int64)
    for s in range(ns):
        p = sparent[s]
        if p >= 0:
            lev[p] = max(lev[p], lev[s] + 1)
    return lev


def level_sets(sparent: np.ndarray) -> list:
    """Supernode ids grouped by level, ascending.  Each returned array is an
    antichain of the supernodal etree."""
    lev = supernode_levels(sparent)
    nlev = int(lev.max()) + 1 if lev.shape[0] else 0
    return [np.flatnonzero(lev == l) for l in range(nlev)]


@dataclass
class BatchGroup:
    """One schedulable batch: same level, same (Lp, Wp) bucket."""
    level: int
    Lp: int
    Wp: int
    ids: np.ndarray  # supernode ids, ascending


@dataclass
class LevelSchedule:
    levels: np.ndarray          # (nsuper,) level of each supernode
    groups: list = field(default_factory=list)  # list[list[BatchGroup]] per level
    # lazily-built device index plan (repro_torch.core.device_store.DeviceGroupPlan);
    # cached here so factorizations and solves sharing this schedule reuse it
    device_plan: object | None = field(default=None, repr=False, compare=False)

    @property
    def n_levels(self) -> int:
        return len(self.groups)

    @property
    def n_batches(self) -> int:
        return sum(len(g) for g in self.groups)

    def batch_stats(self) -> dict:
        sizes = [int(bg.ids.shape[0]) for lg in self.groups for bg in lg]
        return {
            "levels": self.n_levels,
            "batches": self.n_batches,
            "supernodes": int(sum(sizes)),
            "max_batch": int(max(sizes)) if sizes else 0,
            "mean_batch": float(np.mean(sizes)) if sizes else 0.0,
        }


def build_schedule(
    sym: SymbolicFactor,
    *,
    max_batch: int = 256,
    cell_budget: int = 1 << 24,
    bucket: str = "seq",
) -> LevelSchedule:
    """Group each level's supernodes by engine bucket and chunk the groups.

    ``cell_budget`` caps ``batch * max(Lp*Wp, (Lp-Wp)^2)`` — the larger of
    the stacked panel buffer and the stacked update-matrix buffer, in f64
    cells (default 16M cells = 128 MiB) — so huge buckets get small batches.
    ``bucket`` selects the bucket family (see BUCKET_FNS).
    """
    counters.bump("schedule")
    bucket_fn = BUCKET_FNS[bucket]
    lev = supernode_levels(sym.sparent)
    nlev = int(lev.max()) + 1 if sym.nsuper else 0
    groups: list = []
    for l in range(nlev):
        ids = np.flatnonzero(lev == l)
        by_bucket: dict = {}
        for s in ids:
            key = bucket_fn(int(sym.rows[s].shape[0]), sym.width(int(s)))
            by_bucket.setdefault(key, []).append(int(s))
        lgroups = []
        for (Lp, Wp), members in sorted(by_bucket.items()):
            cap = max(1, min(max_batch, cell_budget // max(Lp * Wp, (Lp - Wp) ** 2)))
            # round down to a power of two: the engine pads every batch to
            # the next power of two, so a pow2 cap keeps full chunks unpadded
            # and the cell budget honest
            cap = 1 << (cap.bit_length() - 1)
            for c0 in range(0, len(members), cap):
                lgroups.append(BatchGroup(
                    level=l, Lp=Lp, Wp=Wp,
                    ids=np.asarray(members[c0:c0 + cap], dtype=np.int64),
                ))
        groups.append(lgroups)
    return LevelSchedule(levels=lev, groups=groups)


def group_flop_stats(sym: SymbolicFactor, sched: LevelSchedule, *,
                     nb: int = 128, tile: int = 128) -> dict:
    """Padded-FLOP waste accounting for a schedule, per group and in total.

    Uses one consistent column-op cost model for all three execution modes
    (constant factors cancel in the ratios):

        true    Σ_s  w·(w+m)·w + m·w·m          exact supernode extents
        padded  Σ_g  Bp·(Wp·Lp·Wp + mp·Wp·mp)   every lane at full bucket
                                                 extent (the unfused xla path)
        masked  Σ_lanes  wc·Lp·Wp + mp·Wp·mc    the fused masked kernel:
                                                 pad lanes skipped, factor
                                                 columns rounded up to the
                                                 ``nb`` slab, SYRK tail
                                                 rounded up to the tile

    Returns ``{"true", "padded", "masked", "padded_waste", "masked_waste",
    "groups": [...]}`` — the waste figures are padded/true and masked/true
    ratios (1.0 = no wasted flops).
    """
    tot_true = tot_pad = tot_masked = 0
    per_group = []
    for lgroups in sched.groups:
        for bg in lgroups:
            Lp, Wp = bg.Lp, bg.Wp
            mp = Lp - Wp
            Bp = 1
            while Bp < bg.ids.shape[0]:
                Bp *= 2
            tu = syrk_tile(mp, tile) if mp else 1
            g_true = g_masked = 0
            for s in bg.ids:
                s = int(s)
                w = sym.width(s)
                m = sym.rows[s].shape[0] - w
                g_true += w * (w + m) * w + m * w * m
                wc = min(-(-w // nb) * nb, Wp)
                mc = min(-(-m // tu) * tu, mp) if m else 0
                g_masked += wc * Lp * Wp + mp * Wp * mc
            g_pad = Bp * (Wp * Lp * Wp + mp * Wp * mp)
            tot_true += g_true
            tot_pad += g_pad
            tot_masked += g_masked
            per_group.append({
                "level": bg.level, "Lp": Lp, "Wp": Wp,
                "B": int(bg.ids.shape[0]), "Bp": Bp,
                "true": g_true, "padded": g_pad, "masked": g_masked,
            })
    return {
        "true": tot_true, "padded": tot_pad, "masked": tot_masked,
        "padded_waste": tot_pad / tot_true if tot_true else 0.0,
        "masked_waste": tot_masked / tot_true if tot_true else 0.0,
        "groups": per_group,
    }


def cached_schedule(
    sym: SymbolicFactor,
    *,
    max_batch: int = 256,
    cell_budget: int = 1 << 24,
    bucket: str = "seq",
) -> LevelSchedule:
    """Cached accessor mirroring ``relind.scatter_plan``: build once per
    (max_batch, cell_budget, bucket) per SymbolicFactor, reuse across
    factorizations."""
    if sym.schedules is None:
        sym.schedules = {}
    key = (max_batch, cell_budget, bucket)
    sched = sym.schedules.get(key)
    if sched is None:
        sched = sym.schedules[key] = build_schedule(
            sym, max_batch=max_batch, cell_budget=cell_budget, bucket=bucket
        )
    return sched

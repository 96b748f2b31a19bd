"""Generalized relative indices (Schreiber [3], Ashcraft [4]) and the block
structure that drives RLB.

For supernode ``s`` with tail rows ``t`` (the rows below its diagonal block):

  * RL needs, for every ancestor ``a`` whose columns intersect ``t``, the
    positions of *all* tail rows >= a's first column inside ``rows[a]``
    ("generalized relative indices for each row in the supernode").

  * RLB needs one relative index per *block*: a block is a maximal run of
    tail rows that (i) land in the same ancestor's column range and (ii) are
    contiguous in that ancestor's row structure.  Fewer/larger blocks mean
    fewer/larger BLAS calls — which is what partition refinement optimizes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core import counters
from repro_torch.core.symbolic import SymbolicFactor


@dataclass
class AncestorUpdate:
    """Update footprint of supernode s inside ancestor a (for RL)."""
    anc: int                  # ancestor supernode
    k0: int                   # first tail position whose row is a column of a
    k1: int                   # one past the last such position
    col_off: np.ndarray       # (k1-k0,): column offsets inside a
    rel_rows: np.ndarray      # positions in rows[a] of tail[k0:] (all rows >= a's start)


def ancestor_updates(sym: SymbolicFactor, s: int) -> list[AncestorUpdate]:
    w = sym.width(s)
    t = sym.rows[s][w:]
    out: list[AncestorUpdate] = []
    m = t.shape[0]
    k = 0
    while k < m:
        a = int(sym.snode[t[k]])
        fa, la = int(sym.super_ptr[a]), int(sym.super_ptr[a + 1])
        k1 = int(np.searchsorted(t, la))
        rel = np.searchsorted(sym.rows[a], t[k:])
        # membership sanity (cheap, catches symbolic bugs early)
        # note: rows[a] must contain every tail row >= fa
        out.append(AncestorUpdate(
            anc=a, k0=k, k1=k1,
            col_off=t[k:k1] - fa,
            rel_rows=rel.astype(np.int64),
        ))
        k = k1
    return out


@dataclass
class Block:
    """A maximal tail-row run of supernode s contiguous inside ancestor anc."""
    anc: int        # ancestor supernode owning these rows as columns
    k0: int         # tail-position range [k0, k1)
    k1: int
    col_off0: int   # first column offset inside anc (columns are contiguous)
    row_pos0: int   # first row position inside rows[anc] (rows are contiguous)


def supernode_blocks(sym: SymbolicFactor, s: int) -> list[Block]:
    """Partition the tail rows of s into RLB blocks."""
    w = sym.width(s)
    t = sym.rows[s][w:]
    m = t.shape[0]
    blocks: list[Block] = []
    k = 0
    while k < m:
        a = int(sym.snode[t[k]])
        fa, la = int(sym.super_ptr[a]), int(sym.super_ptr[a + 1])
        k1 = int(np.searchsorted(t, la))
        pos = np.searchsorted(sym.rows[a], t[k:k1]).astype(np.int64)
        # split the [k, k1) run at discontinuities in the ancestor's rows
        cut = np.flatnonzero(np.diff(pos) != 1) + 1
        bounds = np.concatenate([[0], cut, [k1 - k]])
        for b in range(bounds.shape[0] - 1):
            b0, b1 = int(bounds[b]), int(bounds[b + 1])
            blocks.append(Block(
                anc=a, k0=k + b0, k1=k + b1,
                col_off0=int(t[k + b0] - fa),
                row_pos0=int(pos[b0]),
            ))
        k = k1
    return blocks


# ---------------------------------------------------------------------------
# precomputed scatter plans (RL assembly without per-ancestor Python loops)
# ---------------------------------------------------------------------------
@dataclass
class ScatterPlan:
    """Flat-index assembly plan for the whole factorization.

    Supernode panels are laid out back to back in one flat float64 storage
    array: panel ``s`` (``rows_s`` x ``w_s``, C order) occupies
    ``storage[offs[s]:offs[s+1]]``, and one extra *trash* cell sits at
    ``storage[trash]`` (``trash == offs[-1]``).

    ``dst[s]`` is a flat int64 array of length ``m*m`` (``m`` = tail rows of
    ``s``): entry ``i*m + j`` is the storage index the update-matrix entry
    ``U[i, j]`` must be subtracted from.  Lower-triangle entries (``j <= i``)
    map into the owning ancestor's panel (row = position of tail row ``i`` in
    ``rows[anc]``, column = tail row ``j`` minus the ancestor's first column);
    strict upper-triangle entries map to the trash cell, so the whole update
    is applied with ONE vectorized fancy-indexed subtraction:

        storage[dst[s]] -= U.ravel()

    Destinations are unique except for the (don't-care) trash cell, which
    makes plain fancy indexing exact — no ``np.subtract.at`` needed.  The plan
    depends only on the symbolic factorization and is shared by the
    sequential (``factorize_rl``) and level-scheduled batched paths.
    """
    offs: np.ndarray   # (nsuper+1,) int64 panel offsets into flat storage
    trash: int         # discard cell index (== offs[-1])
    dst: list          # per supernode: (m*m,) flat destination indices
                       # (int32 when storage fits, else int64 — see below)

    @property
    def storage_cells(self) -> int:
        return self.trash + 1


def build_scatter_plan(sym: SymbolicFactor) -> ScatterPlan:
    """Precompute the full assembly plan (symbolic phase; O(update entries))."""
    counters.bump("scatter_plan")
    ns = sym.nsuper
    offs = np.zeros(ns + 1, dtype=np.int64)
    for s in range(ns):
        offs[s + 1] = offs[s] + sym.rows[s].shape[0] * sym.width(s)
    trash = int(offs[ns])
    # the plan is as large as every update matrix combined and lives for the
    # whole symbolic factor — use int32 whenever storage fits (always, short
    # of ~16 GiB of factor) to halve its footprint
    idx_t = np.int32 if trash < np.iinfo(np.int32).max else np.int64
    dst: list = []
    for s in range(ns):
        w = sym.width(s)
        t = sym.rows[s][w:]
        m = t.shape[0]
        if m == 0:
            dst.append(np.empty(0, dtype=idx_t))
            continue
        D = np.empty((m, m), dtype=idx_t)
        k = 0
        while k < m:  # one segment per ancestor, as in ancestor_updates
            a = int(sym.snode[t[k]])
            fa, la = int(sym.super_ptr[a]), int(sym.super_ptr[a + 1])
            k1 = int(np.searchsorted(t, la))
            wa = la - fa
            rel = np.searchsorted(sym.rows[a], t[k:]).astype(np.int64)
            co = t[k:k1] - fa
            D[k:, k:k1] = offs[a] + rel[:, None] * wa + co[None, :]
            k = k1
        iu = np.triu_indices(m, 1)
        D[iu] = trash
        dst.append(D.reshape(-1))
    return ScatterPlan(offs=offs, trash=trash, dst=dst)


def scatter_plan(sym: SymbolicFactor) -> ScatterPlan:
    """Cached accessor: build once per SymbolicFactor, reuse across
    factorizations (merge/refine return fresh objects, so no staleness)."""
    if sym.plan is None:
        sym.plan = build_scatter_plan(sym)
    return sym.plan


def count_blocks(sym: SymbolicFactor) -> int:
    """Total number of RLB blocks — the quantity partition refinement reduces."""
    return sum(len(supernode_blocks(sym, s)) for s in range(sym.nsuper))


def count_blas_calls(sym: SymbolicFactor) -> int:
    """Number of DSYRK/DGEMM calls RLB would make (one SYRK per block plus one
    GEMM per ordered block pair)."""
    total = 0
    for s in range(sym.nsuper):
        nb = len(supernode_blocks(sym, s))
        total += nb * (nb + 1) // 2
    return total

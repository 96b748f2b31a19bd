"""Partition-refinement reordering of columns within supernodes
(Jacquelin–Ng–Peyton [11], Karsavuran–Ng–Peyton [12]).

RLB issues one DSYRK/DGEMM per block pair, so its performance is governed by
the number of blocks.  Reordering the columns *within* each supernode never
changes the fill, but it can make the update footprints of descendant
supernodes contiguous, collapsing many small blocks into few large ones.

For each supernode ``a`` we collect the restriction sets
``R_d = tail(d) ∩ cols(a)`` of every descendant ``d`` that updates ``a`` and
run ordered partition refinement: cells are split by each ``R_d`` with the
touched part placed toward the previously-touched region, which drives each
``R_d`` toward a contiguous column range.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.symbolic import SymbolicFactor


def refine_cell_order(width: int, restrictions: list[np.ndarray]) -> np.ndarray:
    """Ordered partition refinement on ``range(width)``.

    restrictions: list of int arrays (column offsets in [0, width)).
    Returns a permutation ``g`` of range(width): new position k holds old
    column ``g[k]``.
    """
    if width == 1 or not restrictions:
        return np.arange(width, dtype=np.int64)
    cells: list[np.ndarray] = [np.arange(width, dtype=np.int64)]
    # bigger restriction sets first: they establish the coarse layout
    for R in sorted(restrictions, key=lambda r: -r.shape[0]):
        if R.shape[0] in (0, width):
            continue
        inR = np.zeros(width, dtype=bool)
        inR[R] = True
        new_cells: list[np.ndarray] = []
        seen_touched = False
        for C in cells:
            m = inR[C]
            hit = C[m]
            miss = C[~m]
            if hit.size == 0 or miss.size == 0:
                new_cells.append(C)
                if hit.size:
                    seen_touched = True
                continue
            if not seen_touched:
                # first touched cell: put hits last so they abut the next one
                new_cells.append(miss)
                new_cells.append(hit)
                seen_touched = True
            else:
                new_cells.append(hit)
                new_cells.append(miss)
        cells = new_cells
    return np.concatenate(cells)


def collect_restrictions(sym: SymbolicFactor) -> list[list[np.ndarray]]:
    """restrictions[a] = list of col-offset arrays from descendants updating a."""
    out: list[list[np.ndarray]] = [[] for _ in range(sym.nsuper)]
    for s in range(sym.nsuper):
        w = sym.width(s)
        t = sym.rows[s][w:]
        m = t.shape[0]
        k = 0
        while k < m:
            a = int(sym.snode[t[k]])
            fa, la = int(sym.super_ptr[a]), int(sym.super_ptr[a + 1])
            k1 = int(np.searchsorted(t, la))
            out[a].append((t[k:k1] - fa).astype(np.int64))
            k = k1
    return out


def refine_partition(sym: SymbolicFactor) -> tuple[SymbolicFactor, np.ndarray]:
    """Compute the within-supernode reordering and apply it to the symbolic
    factor.  Returns (new_sym, g) where g is the global permutation to apply
    to the already-permuted matrix: ``A2 = A[g][:, g]``."""
    n = sym.n
    restrictions = collect_restrictions(sym)
    g = np.arange(n, dtype=np.int64)
    for a in range(sym.nsuper):
        fa, la = int(sym.super_ptr[a]), int(sym.super_ptr[a + 1])
        w = la - fa
        if w > 1 and restrictions[a]:
            local = refine_cell_order(w, restrictions[a])
            g[fa:la] = fa + local

    # relabel: old label r -> new label gmap[r]
    gmap = np.empty(n, dtype=np.int64)
    gmap[g] = np.arange(n, dtype=np.int64)

    rows = []
    for s in range(sym.nsuper):
        w = sym.width(s)
        tail = np.sort(gmap[sym.rows[s][w:]])
        rows.append(np.concatenate([sym.rows[s][:w], tail]))

    # rebuild the column etree consistent with the relabeling
    parent = np.full(n, -1, dtype=np.int64)
    for s in range(sym.nsuper):
        f, l = int(sym.super_ptr[s]), int(sym.super_ptr[s + 1])
        parent[f:l - 1] = np.arange(f + 1, l, dtype=np.int64)
        t = rows[s][l - f:]
        parent[l - 1] = t[0] if t.shape[0] else -1

    new_sym = SymbolicFactor(
        n=n, perm=sym.perm[g], parent=parent, super_ptr=sym.super_ptr.copy(),
        rows=rows, snode=sym.snode.copy(), sparent=sym.sparent.copy(),
        colcount=None,
    )
    return new_sym, g


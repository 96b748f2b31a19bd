"""Supernode amalgamation (Ashcraft–Grimes [8], as configured in the paper).

The paper: "We merged supernode pairs J and p(J) in a sequence ... We selected
pairs to be merged to minimize at each step the amount of new fill in the
factor matrix. Then our algorithm stopped when the cumulative increase in
factor matrix storage went beyond 25%."

Merging is restricted to (child, parent) pairs that are *column-adjacent*
(the child's columns end where the parent's begin), which keeps supernodes
contiguous.  Because the matrix is postordered, the last child of every
supernode is adjacent to it, so the tree can be coarsened arbitrarily far
through repeated adjacent merges.

Storage is counted in dense-rectangle cells (rows × width), matching the
paper's storage model ("supernode J1 is stored in an array of size 5×2").
"""
from __future__ import annotations

import heapq

import numpy as np

from repro_torch.core.symbolic import SymbolicFactor


def merge_supernodes(sym: SymbolicFactor, *, max_growth: float = 0.25) -> SymbolicFactor:
    """Greedy min-new-fill adjacent (child, parent) merging with a cumulative
    storage-growth cap (default 25% per the paper)."""
    ns = sym.nsuper
    start = sym.super_ptr[:-1].astype(np.int64).copy()
    end = sym.super_ptr[1:].astype(np.int64).copy()
    tails: list = [sym.rows[s][sym.width(s):] for s in range(ns)]
    sparent = sym.sparent.astype(np.int64).copy()

    rep = np.arange(ns, dtype=np.int64)  # union-find

    def find(x: int) -> int:
        root = x
        while rep[root] != root:
            root = rep[root]
        while rep[x] != root:
            rep[x], x = root, rep[x]
        return root

    stamp = np.zeros(ns, dtype=np.int64)
    end_map = {int(end[s]): s for s in range(ns)}  # end column -> supernode

    def dims(s: int) -> tuple[int, int]:
        w = int(end[s] - start[s])
        return w, w + tails[s].shape[0]

    def parent_of(s: int) -> int:
        p = sparent[s]
        if p == -1:
            return -1
        p = find(int(p))
        sparent[s] = p
        return p

    def fill_of(s: int) -> int | None:
        """Storage increase of merging s into its parent, or None if not a
        legal adjacent merge."""
        p = parent_of(s)
        if p == -1 or end[s] != start[p]:
            return None
        ws, ls = dims(s)
        wp, lp = dims(p)
        return (ws + lp) * (ws + wp) - ls * ws - lp * wp

    orig_storage = sum(dims(s)[0] * dims(s)[1] for s in range(ns))
    budget = int(max_growth * orig_storage)
    grown = 0

    heap: list[tuple[int, int, int]] = []
    for s in range(ns):
        f = fill_of(s)
        if f is not None:
            heapq.heappush(heap, (f, int(stamp[s]), s))

    alive = ns
    while heap:
        f, st, s = heapq.heappop(heap)
        if find(s) != s or stamp[s] != st:
            continue
        cur = fill_of(s)
        if cur is None:
            continue
        if cur != f:
            heapq.heappush(heap, (cur, int(stamp[s]), s))
            continue
        if grown + cur > budget:
            if cur > 0:
                break  # cheapest remaining merge busts the cap -> done
        grown += cur
        p = parent_of(s)
        # merge: s absorbs p; merged node keeps rep s, columns [start[s], end[p])
        del end_map[int(end[s])]
        end_map[int(end[p])] = s
        end[s] = end[p]
        tails[s] = tails[p]
        tails[p] = None
        sparent[s] = sparent[p]
        rep[p] = s
        stamp[s] += 1
        alive -= 1
        # re-evaluate: s with its new parent, and the child now adjacent to
        # s's (unchanged) start whose parent's dims just changed.
        nf = fill_of(s)
        if nf is not None:
            heapq.heappush(heap, (nf, int(stamp[s]), s))
        q = end_map.get(int(start[s]))
        if q is not None and find(q) == q:
            stamp[q] += 1
            qf = fill_of(q)
            if qf is not None:
                heapq.heappush(heap, (qf, int(stamp[q]), q))

    # ---- rebuild a SymbolicFactor from the surviving representatives ----
    reps = sorted(int(s) for s in range(ns) if find(s) == s)
    new_ptr = np.empty(len(reps) + 1, dtype=np.int64)
    rows: list = []
    for k, s in enumerate(reps):
        new_ptr[k] = start[s]
        rows.append(np.concatenate([
            np.arange(start[s], end[s], dtype=np.int64), tails[s]
        ]))
    new_ptr[-1] = sym.n
    # sanity: contiguous cover of all columns
    assert np.all(new_ptr[1:-1] == np.array([end[s] for s in reps[:-1]]))

    snode = np.zeros(sym.n, dtype=np.int64)
    for k in range(len(reps)):
        snode[new_ptr[k]:new_ptr[k + 1]] = k
    new_sparent = np.full(len(reps), -1, dtype=np.int64)
    for k, s in enumerate(reps):
        t = tails[s]
        if t.shape[0]:
            new_sparent[k] = snode[t[0]]

    return SymbolicFactor(
        n=sym.n, perm=sym.perm, parent=sym.parent, super_ptr=new_ptr,
        rows=rows, snode=snode, sparent=new_sparent, colcount=sym.colcount,
    )

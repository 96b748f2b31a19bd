"""Fill-reducing orderings.

The paper orders with METIS nested dissection.  METIS is not available
offline, so we implement level-structure nested dissection (recursive BFS
bisection with a level separator) — the classic George/Liu algorithm — which
produces METIS-quality orderings on the PDE-mesh family our suite is built
from, plus RCM (via scipy) as a cheaper fallback.  DESIGN.md records this
substitution.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee


def _csr_pattern(A: sp.spmatrix) -> tuple[np.ndarray, np.ndarray, int]:
    """Strictly off-diagonal symmetric pattern in CSR arrays."""
    A = sp.csr_matrix(A)
    A = A + A.T
    A = sp.csr_matrix(A)
    A.setdiag(0)
    A.eliminate_zeros()
    A.sort_indices()
    return A.indptr.astype(np.int64), A.indices.astype(np.int64), A.shape[0]


def _neighbors(Ap: np.ndarray, Ai: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Vectorized union-of-adjacency for a frontier F (with duplicates)."""
    cnt = Ap[F + 1] - Ap[F]
    total = int(cnt.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    starts = np.repeat(Ap[F], cnt)
    offs = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    return Ai[starts + offs]


def _bfs_levels(Ap, Ai, verts: np.ndarray, root: int, mask: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """BFS over the induced subgraph (mask[v] == True for members).
    Returns (order, level) arrays over the visited vertices."""
    level = np.full(mask.shape[0], -1, dtype=np.int64)
    frontier = np.array([root], dtype=np.int64)
    level[root] = 0
    chunks = [frontier]
    d = 0
    while frontier.size:
        nbr = _neighbors(Ap, Ai, frontier)
        nbr = nbr[mask[nbr] & (level[nbr] < 0)]
        if nbr.size:
            nbr = np.unique(nbr)
        d += 1
        level[nbr] = d
        frontier = nbr
        if nbr.size:
            chunks.append(nbr)
    order = np.concatenate(chunks) if chunks else np.empty(0, dtype=np.int64)
    return order, level


def _pseudo_peripheral(Ap, Ai, verts, mask) -> tuple[int, np.ndarray, np.ndarray]:
    """Find a pseudo-peripheral root; return (root, bfs order, levels)."""
    root = int(verts[0])
    order, level = _bfs_levels(Ap, Ai, verts, root, mask)
    for _ in range(3):
        far = order[-1]
        order2, level2 = _bfs_levels(Ap, Ai, verts, int(far), mask)
        if level2[order2[-1]] <= level[order[-1]]:
            break
        root, order, level = int(far), order2, level2
    return root, order, level


def nested_dissection(A: sp.spmatrix, *, leaf_size: int = 96) -> np.ndarray:
    """Level-structure nested dissection.  Returns permutation ``perm`` such
    that ``A[perm][:, perm]`` has low fill (perm[k] = old index of new k).

    Chunks are collected in "reverse emission order": every separator is
    emitted *before* its two parts are recursed, and the chunk list is
    reversed at the end, which places each separator after everything it
    separates — the ND numbering.
    """
    Ap, Ai, n = _csr_pattern(A)
    ordered_chunks: list[np.ndarray] = []

    work = [np.arange(n, dtype=np.int64)]
    while work:
        verts = work.pop()
        if verts.size == 0:
            continue
        if verts.size <= leaf_size:
            ordered_chunks.append(verts)
            continue
        sub_mask = np.zeros(n, dtype=bool)
        sub_mask[verts] = True
        _root, order, level = _pseudo_peripheral(Ap, Ai, verts, sub_mask)
        # disconnected piece: handle the visited component, requeue the rest
        if order.size < verts.size:
            rest = verts[~np.isin(verts, order, assume_unique=True)]
            work.append(rest)
            verts = order
        nlev = int(level[order].max()) + 1
        if nlev < 3:
            ordered_chunks.append(verts)  # clique-ish: no useful separator
            continue
        # cut at the level containing the median vertex
        lv = level[order]
        counts = np.bincount(lv, minlength=nlev)
        half = np.searchsorted(np.cumsum(counts), verts.size // 2)
        half = min(max(int(half), 1), nlev - 2)
        sep = order[lv == half]
        left = order[lv < half]
        right = order[lv > half]
        ordered_chunks.append(sep)  # reversed at the end -> sep numbered last
        work.append(left)
        work.append(right)

    perm = np.concatenate(ordered_chunks[::-1]) if ordered_chunks else np.empty(0, np.int64)
    assert perm.size == n, (perm.size, n)
    return perm


def rcm_ordering(A: sp.spmatrix) -> np.ndarray:
    return np.asarray(reverse_cuthill_mckee(sp.csr_matrix(A), symmetric_mode=True), dtype=np.int64)


def natural_ordering(A: sp.spmatrix) -> np.ndarray:
    return np.arange(A.shape[0], dtype=np.int64)


def fill_reducing_ordering(A: sp.spmatrix, method: str = "nd") -> np.ndarray:
    if method == "nd":
        return nested_dissection(A)
    if method == "rcm":
        return rcm_ordering(A)
    if method == "natural":
        return natural_ordering(A)
    raise ValueError(f"unknown ordering method: {method}")

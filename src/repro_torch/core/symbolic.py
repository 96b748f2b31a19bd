"""Symbolic analysis for supernodal sparse Cholesky.

Implements the classic pipeline the paper builds on:

  * elimination tree            (Liu [2])
  * postordering
  * column counts               (Gilbert–Ng–Peyton, as in CSparse cs_counts)
  * maximal supernode detection (Liu–Ng–Peyton [7])
  * per-supernode row structure (bottom-up union over the supernodal etree)

Everything here is host-side numpy/python — exactly as in real packages,
where the symbolic phase runs on the CPU and only the numeric phase is
offloaded to the accelerator.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp

from repro_torch.core import counters


# ---------------------------------------------------------------------------
# elimination tree
# ---------------------------------------------------------------------------
def etree(A: sp.csc_matrix) -> np.ndarray:
    """Column elimination tree of a symmetric matrix (pattern of A assumed
    symmetric; only the upper triangle is traversed).  parent[j] = -1 for
    roots.  Liu's algorithm with path compression."""
    A = sp.csc_matrix(A)
    n = A.shape[0]
    Ap, Ai = A.indptr, A.indices
    parent = np.full(n, -1, dtype=np.int64)
    ancestor = np.full(n, -1, dtype=np.int64)
    for j in range(n):
        for p in range(Ap[j], Ap[j + 1]):
            i = Ai[p]
            # traverse from i up to the root of its current tree
            while i != -1 and i < j:
                inext = ancestor[i]
                ancestor[i] = j  # path compression
                if inext == -1:
                    parent[i] = j
                i = inext
    return parent


def postorder(parent: np.ndarray) -> np.ndarray:
    """Postorder of a forest given parent pointers (iterative DFS)."""
    n = parent.shape[0]
    # build first-child / next-sibling in reverse so children pop in order
    head = np.full(n, -1, dtype=np.int64)
    nxt = np.full(n, -1, dtype=np.int64)
    for v in range(n - 1, -1, -1):
        p = parent[v]
        if p != -1:
            nxt[v] = head[p]
            head[p] = v
    post = np.empty(n, dtype=np.int64)
    k = 0
    stack: list[int] = []
    for root in range(n):
        if parent[root] != -1:
            continue
        stack.append(root)
        while stack:
            v = stack[-1]
            c = head[v]
            if c == -1:
                post[k] = v
                k += 1
                stack.pop()
            else:
                head[v] = nxt[c]  # consume child
                stack.append(c)
    assert k == n, "parent array does not describe a forest"
    return post


def _leaf(i, j, first, maxfirst, prevleaf, ancestor):
    """cs_leaf from CSparse: determine if j is a leaf of i's row subtree."""
    if i <= j or first[j] <= maxfirst[i]:
        return 0, -1
    maxfirst[i] = first[j]
    jprev = prevleaf[i]
    prevleaf[i] = j
    if jprev == -1:
        return 1, i  # first leaf
    q = jprev
    while q != ancestor[q]:
        q = ancestor[q]
    s = jprev
    while s != q:
        sparent = ancestor[s]
        ancestor[s] = q
        s = sparent
    return 2, q  # subsequent leaf; q = LCA(jprev, j)


def col_counts(A: sp.csc_matrix, parent: np.ndarray, post: np.ndarray) -> np.ndarray:
    """Column counts of the Cholesky factor L (including the diagonal).
    Port of CSparse's cs_counts for the symmetric case."""
    A = sp.csc_matrix(A)
    n = A.shape[0]
    # we need the *lower* triangle of A organised by row: AT in CSC is A by rows
    AT = sp.csc_matrix(A.T)
    ATp, ATi = AT.indptr, AT.indices

    colcount = np.zeros(n, dtype=np.int64)
    first = np.full(n, -1, dtype=np.int64)
    maxfirst = np.full(n, -1, dtype=np.int64)
    prevleaf = np.full(n, -1, dtype=np.int64)
    ancestor = np.arange(n, dtype=np.int64)

    # delta (stored in colcount): 1 if j is a leaf of its own subtree
    for k in range(n):
        j = post[k]
        colcount[j] = 1 if first[j] == -1 else 0
        while j != -1 and first[j] == -1:
            first[j] = k
            j = parent[j]

    for k in range(n):
        j = post[k]
        if parent[j] != -1:
            colcount[parent[j]] -= 1  # j is not a leaf of parent's subtree
        for p in range(ATp[j], ATp[j + 1]):
            i = ATi[p]  # A[j, i] != 0  ->  column j of row i
            jleaf, q = _leaf(i, j, first, maxfirst, prevleaf, ancestor)
            if jleaf >= 1:
                colcount[j] += 1
            if jleaf == 2:
                colcount[q] -= 1
        if parent[j] != -1:
            ancestor[j] = parent[j]

    # sum deltas up the tree (in postorder, children before parents)
    for k in range(n):
        j = post[k]
        if parent[j] != -1:
            colcount[parent[j]] += colcount[j]
    return colcount


# ---------------------------------------------------------------------------
# supernodes
# ---------------------------------------------------------------------------
@dataclass
class SymbolicFactor:
    """Complete symbolic factorization.

    Column indices refer to the *permuted* matrix (ordering + postorder
    already applied).  ``rows[s]`` holds the global row indices of supernode
    ``s``'s nonzero rows, *including* its own ``width`` diagonal-block rows,
    sorted ascending.  ``snode[j]`` maps a column to its supernode.
    """
    n: int
    perm: np.ndarray           # composite permutation: new k <- old perm[k]
    parent: np.ndarray         # column etree (in permuted numbering)
    super_ptr: np.ndarray      # (nsuper+1,): supernode s = cols [ptr[s], ptr[s+1])
    rows: list                 # list of int64 arrays
    snode: np.ndarray          # (n,): column -> supernode
    sparent: np.ndarray        # supernodal etree parent (-1 for roots)
    colcount: np.ndarray | None = None
    # lazily-built assembly plan (repro_torch.core.relind.ScatterPlan); cached here
    # so repeated factorizations with the same symbolic factor reuse it
    plan: object | None = field(default=None, repr=False, compare=False)
    # lazily-built level schedules (repro_torch.core.schedule.LevelSchedule),
    # keyed by (max_batch, cell_budget) — same reuse rationale as ``plan``
    schedules: dict | None = field(default=None, repr=False, compare=False)

    @property
    def nsuper(self) -> int:
        return self.super_ptr.shape[0] - 1

    def width(self, s: int) -> int:
        return int(self.super_ptr[s + 1] - self.super_ptr[s])

    def cols(self, s: int) -> np.ndarray:
        return np.arange(self.super_ptr[s], self.super_ptr[s + 1], dtype=np.int64)

    def size(self, s: int) -> int:
        """Supernode 'size' in the paper's sense: rows * width (array cells)."""
        return int(self.rows[s].shape[0]) * self.width(s)

    def factor_nnz(self) -> int:
        """Stored cells across all supernode arrays (dense rectangles)."""
        return int(sum(self.rows[s].shape[0] * self.width(s) for s in range(self.nsuper)))

    def validate(self) -> None:
        ptr = self.super_ptr
        assert ptr[0] == 0 and ptr[-1] == self.n
        assert np.all(np.diff(ptr) > 0)
        for s in range(self.nsuper):
            r = self.rows[s]
            w = self.width(s)
            assert r.shape[0] >= w
            assert np.all(np.diff(r) > 0), f"rows of supernode {s} not sorted/unique"
            assert np.array_equal(r[:w], self.cols(s)), f"diag rows mismatch in {s}"
            if self.sparent[s] != -1:
                assert self.sparent[s] > s


def find_supernodes(parent: np.ndarray, colcount: np.ndarray) -> np.ndarray:
    """Maximal supernode partition: column j joins j-1's supernode iff
    parent[j-1] == j and colcount[j] == colcount[j-1] - 1.
    Returns super_ptr of shape (nsuper+1,)."""
    n = parent.shape[0]
    starts = [0]
    for j in range(1, n):
        if not (parent[j - 1] == j and colcount[j] == colcount[j - 1] - 1):
            starts.append(j)
    starts.append(n)
    return np.asarray(starts, dtype=np.int64)


def supernode_rows(
    A: sp.csc_matrix, super_ptr: np.ndarray, snode: np.ndarray
) -> tuple[list, np.ndarray]:
    """Row structure of each supernode via bottom-up union:
    rows(s) = cols(s) ∪ {A-pattern below cols(s)} ∪ {child tails above s's end}.
    Returns (rows list, supernodal parent)."""
    A = sp.csc_matrix(A)
    Ap, Ai = A.indptr, A.indices
    nsuper = super_ptr.shape[0] - 1
    rows: list = [None] * nsuper
    sparent = np.full(nsuper, -1, dtype=np.int64)
    children: list[list[int]] = [[] for _ in range(nsuper)]

    for s in range(nsuper):
        f, l = int(super_ptr[s]), int(super_ptr[s + 1])
        pieces = [Ai[Ap[j]:Ap[j + 1]] for j in range(f, l)]
        a_rows = np.unique(np.concatenate(pieces)) if pieces else np.empty(0, np.int64)
        a_rows = a_rows[a_rows >= l]
        tail_pieces = [a_rows]
        for c in children[s]:
            rc = rows[c]
            tail_pieces.append(rc[rc >= l])
        tail = np.unique(np.concatenate(tail_pieces)) if tail_pieces else np.empty(0, np.int64)
        rows[s] = np.concatenate([np.arange(f, l, dtype=np.int64), tail])
        if tail.shape[0]:
            p = int(snode[tail[0]])
            sparent[s] = p
            children[p].append(s)
    return rows, sparent


def symbolic_analyze(
    A: sp.csc_matrix,
    *,
    order: np.ndarray | None = None,
) -> tuple[SymbolicFactor, sp.csc_matrix]:
    """Full symbolic pipeline on (optionally pre-permuted) A.

    Returns the SymbolicFactor and the permuted matrix (CSC, full symmetric).
    """
    counters.bump("symbolic_analyze")
    A = sp.csc_matrix(A)
    n = A.shape[0]
    if order is None:
        order = np.arange(n, dtype=np.int64)
    Aperm = A[order][:, order].tocsc()
    Aperm.sort_indices()

    parent = etree(Aperm)
    post = postorder(parent)
    # compose: permute so that the etree is postordered.  The permuted etree
    # is just a relabeling (no need to recompute), and a postordered tree's
    # identity permutation is a valid postorder.
    order2 = order[post]
    Aperm = A[order2][:, order2].tocsc()
    Aperm.sort_indices()
    inv = np.empty(n, dtype=np.int64)
    inv[post] = np.arange(n, dtype=np.int64)
    parent = np.where(parent[post] >= 0, inv[np.clip(parent[post], 0, n - 1)], -1)
    cc = col_counts(Aperm, parent, np.arange(n, dtype=np.int64))

    super_ptr = find_supernodes(parent, cc)
    snode = np.zeros(n, dtype=np.int64)
    for s in range(super_ptr.shape[0] - 1):
        snode[super_ptr[s]:super_ptr[s + 1]] = s
    rows, sparent = supernode_rows(Aperm, super_ptr, snode)

    sym = SymbolicFactor(
        n=n, perm=order2, parent=parent, super_ptr=super_ptr,
        rows=rows, snode=snode, sparent=sparent, colcount=cc,
    )
    # cross-check: supernode row count == column count of first column
    for s in range(sym.nsuper):
        f = int(super_ptr[s])
        assert rows[s].shape[0] == cc[f], (
            f"symbolic mismatch at supernode {s}: {rows[s].shape[0]} vs {cc[f]}"
        )
    return sym, Aperm

"""The plain reference that decides ``correct``: numpy and scipy only.

It imports nothing of the port and takes nothing that the port made: it
gets the matrices and right-hand sides that the benchmark generated, and
reads the port's answers only to judge them.

* A factor request answers with a permutation ``perm`` and a lower
  triangular ``L`` such that ``A[perm][:, perm] = L L^T``.  ``factor_berr``
  applies both sides to a few Gaussian probe vectors drawn from the seed
  and returns the worst relative gap ``||P A P^T v - L (L^T v)|| /
  ||P A P^T v||``; ``P A P^T v`` is worked out from ``A`` alone.  A
  permutation that is not one, or an ``L`` that is not lower triangular
  with a positive diagonal, reads ``inf``.
* A solve request answers with ``x``; ``solve_resid`` returns the worst
  column's ``||b - A x|| / ||b||``.

The control (``banded_cholesky``, ``banded_solve``) is this reference put
in the port's place one precision below the configuration's float64: a
float32 LAPACK band Cholesky of ``A`` in its natural order (``spbtrf``),
whose factor ``BandFactor`` presents to the same two checks.
"""
from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp


def probes(n: int, p: int, seed: int) -> np.ndarray:
    """(n, p) standard normal probe vectors drawn from ``seed``."""
    g = np.random.default_rng([int(seed) % 2 ** 64, 0x9E37])
    return g.standard_normal((n, p))


def is_permutation(perm: np.ndarray, n: int) -> bool:
    perm = np.asarray(perm)
    if perm.shape != (n,) or not np.issubdtype(perm.dtype, np.integer):
        return False
    if n and (perm.min() < 0 or perm.max() >= n):
        return False
    return bool(np.all(np.bincount(perm, minlength=n) == 1))


class PanelFactor:
    """An ``L`` held as supernode panels, the port's answer as it stands:
    supernode ``s`` owns columns ``super_ptr[s]:super_ptr[s+1]`` (width
    ``w``), ``panels[s]`` is (len(rows[s]), w), its column ``c`` holds
    ``L[rows[s][c:], f + c]``; the strict upper triangle of the top
    ``w x w`` block is not part of ``L``."""

    def __init__(self, super_ptr, rows, panels, n: int):
        self.super_ptr = np.asarray(super_ptr, dtype=np.int64)
        self.rows = rows
        self.panels = panels
        self.n = n

    def well_formed(self) -> bool:
        """Lower triangular, a positive finite diagonal, every panel of its
        supernode's shape, the column blocks covering 0..n."""
        sp_ = self.super_ptr
        if sp_.ndim != 1 or sp_[0] != 0 or sp_[-1] != self.n:
            return False
        if not len(self.rows) == len(self.panels) == len(sp_) - 1:
            return False
        for s, (r, P) in enumerate(zip(self.rows, self.panels)):
            f, w = int(sp_[s]), int(sp_[s + 1] - sp_[s])
            r = np.asarray(r)
            if w <= 0 or P.shape != (r.shape[0], w):
                return False
            if not np.array_equal(r[:w], np.arange(f, f + w)):
                return False
            if r.shape[0] > w and (np.any(np.diff(r[w - 1:]) <= 0)
                                   or r[-1] >= self.n):
                return False
            d = np.diagonal(P[:w])
            if not np.all(np.isfinite(d)) or np.any(d <= 0):
                return False
        return True

    def apply_L(self, V: np.ndarray) -> np.ndarray:
        Y = np.zeros_like(V)
        for s, (r, P) in enumerate(zip(self.rows, self.panels)):
            f = int(self.super_ptr[s])
            w = P.shape[1]
            v = V[f:f + w]
            Y[f:f + w] += np.tril(P[:w]) @ v
            if P.shape[0] > w:
                Y[r[w:]] += P[w:] @ v
        return Y

    def apply_LT(self, V: np.ndarray) -> np.ndarray:
        Z = np.zeros_like(V)
        for s, (r, P) in enumerate(zip(self.rows, self.panels)):
            f = int(self.super_ptr[s])
            w = P.shape[1]
            z = np.tril(P[:w]).T @ V[f:f + w]
            if P.shape[0] > w:
                z += P[w:].T @ V[r[w:]]
            Z[f:f + w] = z
        return Z


def factor_berr(A: sp.spmatrix, perm, L, V: np.ndarray) -> float:
    """Worst relative gap over the probe columns of ``V`` between
    ``P A P^T v`` and ``L (L^T v)``; ``inf`` for a malformed answer."""
    A = sp.csc_matrix(A)
    n = A.shape[0]
    if not is_permutation(perm, n) or not L.well_formed():
        return float("inf")
    W = np.empty_like(V)
    W[perm] = V                      # P^T V
    lhs = (A @ W)[perm]              # P A P^T V
    rhs = L.apply_L(L.apply_LT(V))
    num = np.linalg.norm(lhs - rhs, axis=0)
    den = np.linalg.norm(lhs, axis=0)
    if not np.all(np.isfinite(num)):
        return float("inf")
    return float(np.max(num / den))


def solve_resid(A: sp.spmatrix, x, b: np.ndarray) -> float:
    """Worst column's ``||b - A x|| / ||b||``; ``inf`` for a malformed
    answer."""
    x = np.asarray(x)
    if x.shape != b.shape or not np.all(np.isfinite(x)):
        return float("inf")
    X = x.reshape(b.shape[0], -1).astype(np.float64)
    B = b.reshape(b.shape[0], -1)
    num = np.linalg.norm(B - sp.csc_matrix(A) @ X, axis=0)
    return float(np.max(num / np.linalg.norm(B, axis=0)))


# ---------------------------------------------------------------------------
# control: the reference one precision down
# ---------------------------------------------------------------------------
def bandwidth(A: sp.spmatrix) -> int:
    C = sp.coo_matrix(A)
    return int(np.max(np.abs(C.row.astype(np.int64) - C.col))) if C.nnz else 0


class BandFactor:
    """``L`` in LAPACK's lower band storage, ``c[d, j] = L[j + d, j]``, in
    the natural order (``perm`` the identity)."""

    def __init__(self, c: np.ndarray):
        self.c = c
        self.n = c.shape[1]

    def well_formed(self) -> bool:
        d = self.c[0]
        return bool(np.all(np.isfinite(d)) and np.all(d > 0))

    def apply_L(self, V: np.ndarray) -> np.ndarray:
        Y = np.zeros_like(V)
        n = self.n
        for d in range(self.c.shape[0]):
            Y[d:] += self.c[d, :n - d, None].astype(V.dtype) * V[:n - d]
        return Y

    def apply_LT(self, V: np.ndarray) -> np.ndarray:
        Z = np.zeros_like(V)
        n = self.n
        for d in range(self.c.shape[0]):
            Z[:n - d] += self.c[d, :n - d, None].astype(V.dtype) * V[d:]
        return Z


def banded_cholesky(A: sp.spmatrix, dtype=np.float32) -> BandFactor:
    """The control's factor: LAPACK ``?pbtrf`` of ``A`` in ``dtype``."""
    C = sp.tril(sp.coo_matrix(A)).tocoo()
    n = A.shape[0]
    ab = np.zeros((bandwidth(A) + 1, n), dtype=dtype)
    ab[C.row - C.col, C.col] = C.data
    c = sla.cholesky_banded(ab, lower=True, overwrite_ab=True,
                            check_finite=False)
    return BandFactor(c)


def banded_solve(F: BandFactor, b: np.ndarray) -> np.ndarray:
    """The control's solve, in the factor's precision."""
    x = sla.cho_solve_banded((F.c, True), b.astype(F.c.dtype),
                             check_finite=False)
    return x.astype(np.float64)

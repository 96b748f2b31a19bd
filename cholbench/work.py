"""The work that a factorization and a solve need, from the unpadded
supernode shapes of a symbolic factor.

Frozen here so that padding, bucket shapes, launch splits or a new kernel
cannot move the count; only the work that the inputs need can.  The flop
count is the sum over supernodes of sum_{k < w} (rows - k)^2, the count
of ``chip_smoke.py``'s ``main_path`` (w^3/3 + m w^2 + m^2 w) with its
lower-order terms; the byte counts read each input once and write each
output once.
"""
from __future__ import annotations

import numpy as np


def shapes(sym) -> tuple[np.ndarray, np.ndarray]:
    """(widths, rows) of every supernode of a symbolic factor with
    ``super_ptr`` and ``rows`` (the port's ``SymbolicFactor``)."""
    w = np.diff(np.asarray(sym.super_ptr, dtype=np.int64))
    r = np.array([len(x) for x in sym.rows], dtype=np.int64)
    return w, r


def factor_flops(w: np.ndarray, r: np.ndarray) -> float:
    """sum_s sum_{k < w_s} (r_s - k)^2 = sum_s (S(r_s) - S(r_s - w_s)),
    with S(x) = x (x + 1) (2x + 1) / 6."""
    w = w.astype(np.float64)
    r = r.astype(np.float64)

    def S(x):
        return x * (x + 1) * (2 * x + 1) / 6

    return float(np.sum(S(r) - S(r - w)))


def factor_cells(w: np.ndarray, r: np.ndarray) -> float:
    """Nonzeros of L: each supernode's lower-triangular diagonal block and
    its (r - w) x w tail."""
    w = w.astype(np.float64)
    r = r.astype(np.float64)
    return float(np.sum(w * (w + 1) / 2 + (r - w) * w))


def fused_bytes(w: np.ndarray, r: np.ndarray) -> float:
    """Bytes of the fused factor kernel's lanes: each lane's assembled
    panel read once, its factored panel and the lower triangle of its
    (r - w) x (r - w) update matrix written once, float64."""
    m = (r - w).astype(np.float64)
    return 8.0 * (2.0 * factor_cells(w, r) + float(np.sum(m * (m + 1) / 2)))


def solve_bytes(w: np.ndarray, r: np.ndarray, n: int, nrhs: int) -> float:
    """Bytes of one solve: the factor read once, the right-hand sides read
    once and the solutions written once, float64."""
    return 8.0 * (factor_cells(w, r) + 2.0 * n * nrhs)

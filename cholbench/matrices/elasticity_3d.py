"""3-D linear-elasticity-like operator: 3 dof per vertex of an nx**3 grid,
the 7-point Laplacian coupled by a 3 x 3 block, plus 1e-3 * I.

Frozen copy of ``elasticity_3d`` (and the ``laplacian_3d`` and
``_sym_csc`` it calls) from ``src/repro_torch/sparse/gen.py``, so that a
change to the port's generators cannot move the benchmark's matrices.
numpy and scipy only.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _sym_csc(A: sp.spmatrix) -> sp.csc_matrix:
    A = sp.csc_matrix(A)
    A = (A + A.T) * 0.5
    A.sort_indices()
    return A


def _t(n: int) -> sp.spmatrix:
    e = np.ones(n)
    return sp.diags([-e[:-1], 2 * e, -e[:-1]], [-1, 0, 1])


def _laplacian_3d(nx: int) -> sp.csc_matrix:
    I = sp.eye(nx)
    A = (sp.kron(I, sp.kron(I, _t(nx)))
         + sp.kron(I, sp.kron(_t(nx), I))
         + sp.kron(_t(nx), sp.kron(I, I)))
    return _sym_csc(A + 1e-3 * sp.eye(nx ** 3))


def make(nx: int) -> sp.csc_matrix:
    """kron(L, C) + 1e-3 I: rows 3 * vertex + component."""
    L = _laplacian_3d(nx)
    C = np.array([[2.0, 0.4, 0.2], [0.4, 2.0, 0.4], [0.2, 0.4, 2.0]])
    A = sp.kron(L, C, format="csc")
    A = A + 1e-3 * sp.eye(3 * L.shape[0])
    return _sym_csc(A)

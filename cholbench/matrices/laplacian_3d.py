"""3-D Dirichlet Laplacian, 7-point stencil, plus 1e-3 * I.

Frozen copy of ``laplacian_3d`` (and its ``_sym_csc``) from
``src/repro_torch/sparse/gen.py``, so that a change to the port's
generators cannot move the benchmark's matrices.  numpy and scipy only.
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


def make(nx: int) -> sp.csc_matrix:
    """The nx**3 grid's operator, rows in natural (x fastest) order."""
    I = sp.eye(nx)
    A = (sp.kron(I, sp.kron(I, _t(nx)))
         + sp.kron(I, sp.kron(_t(nx), I))
         + sp.kron(_t(nx), sp.kron(I, I)))
    return _sym_csc(A + 1e-3 * sp.eye(nx ** 3))

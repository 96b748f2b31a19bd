"""The dense operations of the sequential path, on the port's kernels.

Port of ``src/repro/kernels/ops.py`` without its backend knob and its
padding: every kernel masks its ragged edges, so shapes go through as they
are, and the tensor's device picks the kernel (CUDA) or its plain version
(CPU), as in each wrapper.

    gemm_nt(a, b)        a @ b^T                    (kernels/gemm.py)
    syrk_ln(a)           tril(a @ a^T)              (kernels/syrk.py)
    potrf(A)             chol(A), blocked routine   (kernels/potrf.py)
    trsm_rlt(L, B)       X with X L^T = B           (kernels/trsm.py)
    trsm_lln(L, B)       X with L X = B             (the transpose route)
    trsm_llt(L, B)       X with L^T X = B           (the persymmetric flip)
    factor_panel(P, w)   POTRF + TRSM of one supernode panel
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gemm import gemm_nt
from repro_torch.kernels.potrf import potrf
from repro_torch.kernels.syrk import syrk_ln
from repro_torch.kernels.trsm import trsm_rlt

__all__ = ["gemm_nt", "syrk_ln", "potrf", "trsm_rlt", "trsm_lln",
           "trsm_llt", "factor_panel"]


def trsm_lln(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``X`` with ``L X = B``: ``L`` (W, W) lower, ``B`` (W, N).  Through the
    right-side kernel: ``L X = B  <=>  X^T L^T = B^T``."""
    return trsm_rlt(L, B.mT.contiguous()).mT


def trsm_llt(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``X`` with ``L^T X = B``: ``L`` (W, W) lower, ``B`` (W, N).  The
    right-side kernel applies only ``L^{-T}``, so route through the
    persymmetric flip: ``J L^T J`` (J reverses rows and columns) is again
    lower triangular, and ``trsm_rlt(J L^T J, B^T J) = X^T J``."""
    Lf = L.mT.flip(0, 1).contiguous()
    R = trsm_rlt(Lf, B.mT.flip(1).contiguous())
    return R.flip(1).mT


def factor_panel(P: torch.Tensor, w: int) -> torch.Tensor:
    """Factor one supernode panel ``P`` (rows, w): POTRF of the diagonal
    block ``P[:w]`` (lower triangle read) and TRSM of the tail ``P[w:]``.
    Returns the factored (rows, w) panel, strict upper triangle zero."""
    Ld = potrf(P[:w, :w])
    if P.shape[0] > w:
        return torch.cat([Ld, trsm_rlt(Ld, P[w:])], dim=0)
    return Ld

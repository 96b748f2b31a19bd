"""Triangular kernels: the batched lower-triangular inverse and the general
right-side solve ``X L^T = B``.

Both port the TPU kernel ``src/repro/kernels/trsm.py::trsm_rlt``:

    tri_inv_lower  as the solve path uses it: ``engines._invert_diag_fn``
                   calls ``ops.trsm_lln(L, I)`` on every lane, which computes
                   ``L^{-1}``, so the port computes that batched inverse
                   directly (``csrc/tri_inv.cu``);
    trsm_rlt       for any ``B``, as ``ops.factor_panel`` applies it to a
                   supernode's rectangular part: one launch of
                   ``csrc/trsm_rlt.cu`` inverts each 64 x 64 diagonal block
                   of ``L`` in shared memory (the reference uses an XLA
                   triangular solve there) and does the block-column steps.

On a CUDA tensor each launches its kernel; on a CPU tensor each runs its
plain version (``tri_inv_lower_ref``, ``trsm_rlt_ref``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def tri_inv_lower_ref(L: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``solve_triangular(L, I)`` on every lane."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


#: block width of the kernels' diagonal inverses (csrc/tile.cuh: DT)
TRSM_NB = 64


def tri_inv_levels(Wp: int) -> list[tuple[int, int]]:
    """``(h, npairs)`` of each doubling level of ``csrc/tri_inv.cu`` for a
    Wp-wide lane: for g = 1, 2, 4, ... blocks below ``ceil(Wp / 64)``, the
    pairs of h = 64 g wide halves (an odd last group carries up)."""
    nblk = -(-Wp // TRSM_NB)
    out, g = [], 1
    while g < nblk:
        out.append((TRSM_NB * g, -(-(nblk - g) // (2 * g))))
        g *= 2
    return out


def tri_inv_launches(Wp: int) -> int:
    """Kernel launches of one ``tri_inv_lower`` call on Wp-wide lanes: the
    diagonal-block launch and two per doubling level."""
    return 1 + 2 * len(tri_inv_levels(Wp))


def tri_inv_lower(L: torch.Tensor) -> torch.Tensor:
    """Inverse of each lower-triangular (Wp, Wp) lane of a (Bp, Wp, Wp)
    float64 stack (upper triangle ignored on input, zero on output).  The
    lanes need contiguous rows only: a view such as ``P[:, :Wp, :]`` of a
    (Bp, Lp, Wp) group passes without a copy.  Returns a contiguous stack.
    ``tri_inv_lower.launches`` counts the calls that launched the CUDA
    kernel."""
    if L.device.type == "cpu":
        return tri_inv_lower_ref(L)
    if L.device.type != "cuda":
        raise ValueError(f"unsupported device {L.device}")
    if L.dim() != 3 or L.dtype != torch.float64 or L.shape[1] != L.shape[2]:
        raise ValueError("L must be a (Bp, Wp, Wp) float64 tensor")
    Bp, Wp, _ = L.shape
    if Wp > 1 and not (L.stride(2) == 1 and Wp <= L.stride(1) < 2 ** 31
                       and 0 <= L.stride(0) < 2 ** 31):
        raise ValueError(f"L must have contiguous rows, got strides "
                         f"{L.stride()}")
    X = L.new_empty((Bp, Wp, Wp))
    if Bp == 0 or Wp == 0:
        return X
    ts = max((h * h * n for h, n in tri_inv_levels(Wp)), default=0)
    T = L.new_empty((max(Bp * ts, 1),))
    lib = _build.load("tri_inv")
    rc = lib.tri_inv_lower_launch(
        L.data_ptr(), max(L.stride(1), Wp), L.stride(0), X.data_ptr(),
        T.data_ptr(), ts, Bp, Wp, L.device.index, _build.stream(L.device))
    _build.check(lib, "tri_inv_lower_error", rc, "tri_inv_lower")
    tri_inv_lower.launches += 1
    return X


tri_inv_lower.launches = 0


def trsm_rlt_ref(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``X`` with ``X L^T = B`` from
    ``solve_triangular`` (which reads only the lower triangle of ``L``)."""
    return torch.linalg.solve_triangular(L, B.mT, upper=False).mT


def trsm_rlt(L: torch.Tensor, B: torch.Tensor, *,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """Solve ``X L^T = B`` for ``X``: ``L`` (W, W) float64 lower triangular
    (its strict upper triangle is never used), ``B`` (M, W) float64, both
    with contiguous rows.  Returns a contiguous (M, W) tensor, or writes X
    into ``out`` (an (M, W) float64 matrix with contiguous rows, which may
    be ``B`` itself -- each row block of B is read before its X is written
    -- but must not otherwise overlap ``B`` or ``L``) and returns ``out``.
    One kernel launch, which also inverts the 64-wide diagonal blocks;
    ``trsm_rlt.launches`` counts the calls that launched it."""
    if L.device.type == "cpu":
        X = trsm_rlt_ref(L, B)
        return X if out is None else out.copy_(X)
    if L.device.type != "cuda":
        raise ValueError(f"unsupported device {L.device}")
    _build.check_matrix("L", L, L.device)
    _build.check_matrix("B", B, L.device)
    W = L.shape[0]
    if L.shape[1] != W or B.shape[1] != W:
        raise ValueError(f"L must be (W, W) and B (M, W); got "
                         f"{tuple(L.shape)} and {tuple(B.shape)}")
    M = B.shape[0]
    if out is None:
        X = B.new_empty((M, W))
    else:
        _build.check_matrix("out", out, L.device)
        if out.shape != B.shape:
            raise ValueError(f"out must be {tuple(B.shape)}, got "
                             f"{tuple(out.shape)}")
        X = out
    if M == 0 or W == 0:
        return X
    lib = _build.load("trsm_rlt")
    rc = lib.trsm_rlt_launch(
        B.data_ptr(), _build.ld(B), L.data_ptr(), _build.ld(L),
        X.data_ptr(), _build.ld(X), M, W, L.device.index,
        _build.stream(L.device))
    _build.check(lib, "trsm_rlt_error", rc, "trsm_rlt")
    trsm_rlt.launches += 1
    return X


trsm_rlt.launches = 0

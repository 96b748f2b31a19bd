"""Triangular kernels: the batched lower-triangular inverse and the general
right-side solve ``X L^T = B``.

Both port the TPU kernel ``src/repro/kernels/trsm.py::trsm_rlt``:

    tri_inv_lower  as the solve path uses it: ``engines._invert_diag_fn``
                   calls ``ops.trsm_lln(L, I)`` on every lane, which computes
                   ``L^{-1}``, so the port computes that batched inverse
                   directly (``csrc/tri_inv.cu``);
    trsm_rlt       for any ``B``, as ``ops.factor_panel`` applies it to a
                   supernode's rectangular part: the 64 x 64 diagonal blocks
                   of ``L`` are inverted by ``tri_inv_lower`` (the reference
                   uses an XLA triangular solve there), then one launch of
                   ``csrc/trsm_rlt.cu`` does the block-column steps.

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


def tri_inv_lower(L: torch.Tensor) -> torch.Tensor:
    """Inverse of each lower-triangular (Wp, Wp) lane of a (Bp, Wp, Wp)
    float64 stack (upper triangle ignored on input, zero on output).
    ``tri_inv_lower.launches`` counts the calls that launched the CUDA
    kernel."""
    if L.device.type == "cpu":
        return tri_inv_lower_ref(L)
    if L.device.type != "cuda":
        raise ValueError(f"unsupported device {L.device}")
    if L.dim() != 3 or L.dtype != torch.float64 or L.shape[1] != L.shape[2]:
        raise ValueError("L must be a (Bp, Wp, Wp) float64 tensor")
    if not L.is_contiguous():
        raise ValueError("L must be contiguous")
    Bp, Wp, _ = L.shape
    X = torch.empty_like(L)
    lib = _build.load("tri_inv")
    rc = lib.tri_inv_lower_launch(
        L.data_ptr(), X.data_ptr(), Bp, Wp, L.device.index or 0,
        _build.stream(L.device))
    _build.check(lib, "tri_inv_lower_error", rc, "tri_inv_lower")
    tri_inv_lower.launches += 1
    return X


tri_inv_lower.launches = 0


#: block width of ``trsm_rlt``'s diagonal inverses (csrc/trsm_rlt.cu: NB)
TRSM_NB = 64


def trsm_rlt_ref(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``X`` with ``X L^T = B`` from
    ``solve_triangular`` (which reads only the lower triangle of ``L``)."""
    return torch.linalg.solve_triangular(L, B.mT, upper=False).mT


def _diag_blocks(L: torch.Tensor, nb: int) -> torch.Tensor:
    """The (ceil(W/nb), nb, nb) stack of ``L``'s diagonal blocks, the last
    one's pad extended by the identity (upper triangles are left as they
    are: ``tri_inv_lower`` ignores them)."""
    W = L.shape[0]
    nfull, rem = divmod(W, nb)
    tiles = L.new_zeros((nfull + (rem > 0), nb, nb))
    if nfull:
        ldl = L.stride(0)
        tiles[:nfull] = L.as_strided((nfull, nb, nb), (nb * ldl + nb, ldl, 1))
    if rem:
        j0 = nfull * nb
        tiles[nfull, :rem, :rem] = L[j0:, j0:]
        idx = torch.arange(rem, nb, device=L.device)
        tiles[nfull, idx, idx] = 1.0
    return tiles


def trsm_rlt(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve ``X L^T = B`` for ``X``: ``L`` (W, W) float64 lower triangular
    (its strict upper triangle is never read), ``B`` (M, W) float64, both
    with contiguous rows.  Returns a contiguous (M, W) tensor.
    ``trsm_rlt.launches`` counts the calls that launched the CUDA kernel
    (the diagonal inverses count on ``tri_inv_lower``)."""
    if L.device.type == "cpu":
        return trsm_rlt_ref(L, B)
    if L.device.type != "cuda":
        raise ValueError(f"unsupported device {L.device}")
    _build.check_matrix("L", L, L.device)
    _build.check_matrix("B", B, L.device)
    W = L.shape[0]
    if L.shape[1] != W or B.shape[1] != W:
        raise ValueError(f"L must be (W, W) and B (M, W); got "
                         f"{tuple(L.shape)} and {tuple(B.shape)}")
    M = B.shape[0]
    X = B.new_empty((M, W))
    if M == 0 or W == 0:
        return X
    invd = tri_inv_lower(_diag_blocks(L, TRSM_NB))
    lib = _build.load("trsm_rlt")
    rc = lib.trsm_rlt_launch(
        B.data_ptr(), _build.ld(B), L.data_ptr(), _build.ld(L),
        invd.data_ptr(), X.data_ptr(), W, M, W, L.device.index or 0,
        _build.stream(L.device))
    _build.check(lib, "trsm_rlt_error", rc, "trsm_rlt")
    trsm_rlt.launches += 1
    return X


trsm_rlt.launches = 0

"""Dense lower Cholesky: the tile kernel ``chol_tile`` and the blocked
routine ``potrf``.

``chol_tile`` is the port of the TPU kernel
``src/repro/kernels/potrf.py::chol_tile``: on a CUDA tensor it launches the
hand-written kernel in ``csrc/chol_tile.cu`` (one tile of at most 128 x 128
in one block's shared memory, see the note there); on a CPU tensor it runs
``chol_tile_ref``.

``potrf`` is the reference's blocked routine (``potrf.py:70-105``) in Python,
one step per 128 columns:

    L_kk = chol_tile(A_kk)
    X    = gemm_nt(A_{k+1:,k}, tri_inv_lower(L_kk))     # A_{k+1:,k} L_kk^{-T}
    A_{k+1:,k+1:} -= syrk_ln(X)                         # trailing update

where the reference inverts ``L_kk`` with an XLA triangular solve and the
port with its ``tri_inv_lower`` kernel.  The trailing subtraction is
elementwise PyTorch.  Every step goes through the wrappers, so the routine
runs the kernels on a card and their plain versions on the CPU.  The
kernels mask ragged edges, so no width is padded.  Only the lower triangle
of the input is read.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemm import gemm_nt
from repro_torch.kernels.syrk import syrk_ln
from repro_torch.kernels.trsm import tri_inv_lower

#: tile edge of the blocked routine (the reference's nb)
NB = 128


def _lower_sym(A: torch.Tensor) -> torch.Tensor:
    """The symmetric matrix the lower triangle of ``A`` stands for."""
    return torch.tril(A) + torch.tril(A, -1).mT


def chol_tile_ref(A: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``torch.linalg.cholesky_ex`` of the symmetric
    matrix ``A``'s lower triangle stands for.  A matrix with a failed pivot
    gives a NaN factor (the kernel takes the square root of the negative
    pivot; the reference's xla lowering NaN-fills), never an exception."""
    L, info = torch.linalg.cholesky_ex(_lower_sym(A))
    return torch.where(info > 0, torch.full((), float("nan"), dtype=L.dtype,
                                            device=L.device), L)


def chol_tile(A: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of one (n, n) float64 tile, n <= 128, read from its
    lower triangle (rows contiguous).  Returns a contiguous lower (n, n)
    tensor with a zero strict upper triangle.  ``chol_tile.launches`` counts
    the calls that launched the CUDA kernel."""
    if A.device.type == "cpu":
        return chol_tile_ref(A)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    _build.check_matrix("A", A, A.device)
    n = A.shape[0]
    if A.shape[1] != n or not 1 <= n <= NB:
        raise ValueError(f"A must be (n, n) with 1 <= n <= {NB}, got "
                         f"{tuple(A.shape)}")
    L = A.new_empty((n, n))
    lib = _build.load("chol_tile")
    rc = lib.chol_tile_launch(
        A.data_ptr(), _build.ld(A), L.data_ptr(), n, n, A.device.index or 0,
        torch.cuda.current_stream(A.device).cuda_stream)
    _build.check(lib, "chol_tile_error", rc, "chol_tile")
    chol_tile.launches += 1
    return L


chol_tile.launches = 0


#: plain PyTorch version of ``potrf``: the same function as the tile's
potrf_ref = chol_tile_ref


def potrf(A: torch.Tensor) -> torch.Tensor:
    """Blocked lower Cholesky of a (W, W) float64 matrix given by its lower
    triangle.  Returns a new contiguous L with a zero strict upper
    triangle; ``A`` is not modified."""
    if A.dim() != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"A must be square, got {tuple(A.shape)}")
    W = A.shape[0]
    if W <= NB:
        return chol_tile(A)
    a = A.clone(memory_format=torch.contiguous_format)  # the trailing matrix
    L = torch.zeros_like(a)
    for k0 in range(0, W, NB):
        k1 = min(k0 + NB, W)
        lkk = chol_tile(a[k0:k1, k0:k1])
        L[k0:k1, k0:k1] = lkk
        if k1 == W:
            break
        x = gemm_nt(a[k1:, k0:k1], tri_inv_lower(lkk[None])[0])
        a[k1:, k1:] -= syrk_ln(x)
        L[k1:, k0:k1] = x
    return L

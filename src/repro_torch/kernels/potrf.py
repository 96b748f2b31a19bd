"""Dense lower Cholesky: the tile kernel ``chol_tile`` and the blocked
routine ``potrf``.

``chol_tile`` is the port of the TPU kernel
``src/repro/kernels/potrf.py::chol_tile``: on a CUDA tensor it launches the
hand-written kernel in ``csrc/chol_tile.cu`` (one tile of at most 128 x 128
in one block's shared memory, factored in 8-wide sub-blocks with DMMA
fragments; see the note there); on a CPU tensor it runs ``chol_tile_ref``.

``potrf`` is the reference's blocked routine (``potrf.py:70-105``) in
Python, one step per 128 columns, in place on one copy of the input's
lower triangle:

    L_kk = chol_tile(A_kk)                    # over A_kk
    X    = trsm_rlt(L_kk, A_{k+1:,k})         # X L_kk^T = A_{k+1:,k}, over it
    A_{k+1:,k+1:} -= X X^T  (lower triangle)  # syrk_ln_sub, in place

The reference computes ``X`` as ``A_{k+1:,k} @ inv(L_kk)^T`` and the
trailing matrix as ``trail - syrk_ln(X)``; the port solves with its
one-launch ``trsm_rlt`` (whose error follows the conditioning of L_kk's
64-wide diagonal blocks, not of L_kk) and subtracts in place, so a step
below the last is three launches and no PyTorch operation, and the
routine one ``tril`` copy besides.  Bound: W^3/3 flops at the fp64
tensor-core peak for large W; what holds it back is the host's three
wrapper calls a step (20-40 us each on the card's machine) and the
latency-bound ``chol_tile``.  Every step goes through the wrappers, so the
routine runs the kernels on a card and their plain versions on the CPU.
The kernels mask ragged edges, so no width is padded.  Only the lower
triangle of the input is read.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.syrk import syrk_ln_sub
from repro_torch.kernels.trsm import trsm_rlt

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


def chol_tile(A: torch.Tensor, *,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """Cholesky factor of one (n, n) float64 tile, n <= 128, read from its
    lower triangle (rows contiguous).  Returns a contiguous lower (n, n)
    tensor with a zero strict upper triangle, or writes it into ``out``
    (an (n, n) float64 matrix with contiguous rows, which may be ``A``
    itself but must not otherwise overlap it) and returns ``out``.
    ``chol_tile.launches`` counts the calls that launched the CUDA
    kernel."""
    if A.device.type == "cpu":
        L = chol_tile_ref(A)
        return L if out is None else out.copy_(L)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    _build.check_matrix("A", A, A.device)
    n = A.shape[0]
    if A.shape[1] != n or not 1 <= n <= NB:
        raise ValueError(f"A must be (n, n) with 1 <= n <= {NB}, got "
                         f"{tuple(A.shape)}")
    if out is None:
        out = A.new_empty((n, n))
    else:
        _build.check_matrix("out", out, A.device)
        if out.shape != A.shape:
            raise ValueError(f"out must be ({n}, {n}), got "
                             f"{tuple(out.shape)}")
    lib = _build.load("chol_tile")
    rc = lib.chol_tile_launch(
        A.data_ptr(), _build.ld(A), out.data_ptr(), _build.ld(out), n,
        A.device.index or 0, _build.stream(A.device))
    _build.check(lib, "chol_tile_error", rc, "chol_tile")
    chol_tile.launches += 1
    return out


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
    # the trailing matrix and the factor share one buffer: each step
    # overwrites its column block with L's, and the strict upper triangle
    # stays zero (every kernel writes only on or below the diagonal)
    L = torch.tril(A).contiguous()
    for k0 in range(0, W, NB):
        k1 = min(k0 + NB, W)
        lkk = L[k0:k1, k0:k1]
        chol_tile(lkk, out=lkk)
        if k1 == W:
            break
        x = L[k1:, k0:k1]
        trsm_rlt(lkk, x, out=x)
        syrk_ln_sub(L[k1:, k1:], x)
    return L

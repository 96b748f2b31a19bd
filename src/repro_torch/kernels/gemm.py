"""Dense ``C = A @ B^T``.

``gemm_nt`` is the port of the TPU kernel
``src/repro/kernels/gemm.py::gemm_nt``.  On a CUDA tensor it launches the
hand-written kernel in ``csrc/gemm_nt.cu`` (see the note there); on a CPU
tensor it runs ``gemm_nt_ref``.  Edges are masked in the kernel, so the
operands are never padded.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def gemm_nt_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``a @ b.T``."""
    return a @ b.mT


def gemm_nt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``C = a @ b^T`` for float64 ``a`` (M, K) and ``b`` (N, K) with
    contiguous rows (row slices and column slices of a contiguous matrix
    qualify).  Returns a contiguous (M, N) tensor.  ``gemm_nt.launches``
    counts the calls that launched the CUDA kernel."""
    if a.device.type == "cpu":
        return gemm_nt_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    _build.check_matrix("a", a, a.device)
    _build.check_matrix("b", b, a.device)
    (M, K), (N, Kb) = a.shape, b.shape
    if K != Kb:
        raise ValueError(f"inner dimensions differ: {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if M > 65535 * 64:
        raise ValueError(f"a has {M} rows; the kernel's grid takes at most "
                         f"{65535 * 64}")
    c = a.new_empty((M, N))
    if M == 0 or N == 0:
        return c
    lib = _build.load("gemm_nt")
    rc = lib.gemm_nt_launch(
        a.data_ptr(), _build.ld(a), b.data_ptr(), _build.ld(b), c.data_ptr(),
        max(N, 1), M, N, K, a.device.index, _build.stream(a.device))
    _build.check(lib, "gemm_nt_error", rc, "gemm_nt")
    gemm_nt.launches += 1
    return c


gemm_nt.launches = 0

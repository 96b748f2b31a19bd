"""Batched lower-triangular inverse of a group's diagonal blocks.

``tri_inv_lower`` is the port of the TPU kernel
``src/repro/kernels/trsm.py::trsm_rlt`` as the solve path uses it:
``engines._invert_diag_fn`` calls ``ops.trsm_lln(L, I)`` on every lane, which
computes ``L^{-1}``, so the port computes that batched inverse directly.  On a
CUDA tensor it launches the hand-written kernel in ``csrc/tri_inv.cu`` (see
the note there); on a CPU tensor it runs ``tri_inv_lower_ref``.
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
        torch.cuda.current_stream(L.device).cuda_stream)
    _build.check(lib, "tri_inv_lower_error", rc, "tri_inv_lower")
    tri_inv_lower.launches += 1
    return X


tri_inv_lower.launches = 0

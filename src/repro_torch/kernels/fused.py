"""Fused batched supernode factorization: POTRF + TRSM + SYRK per lane.

``fused_factor_syrk`` is the port of the TPU kernel
``src/repro/kernels/fused.py::fused_factor_syrk`` (guard=False).  On a CUDA
tensor it launches the hand-written kernel in ``csrc/fused_factor_syrk.cu``
(see the note there for the design and its bound); on a CPU tensor it runs
``fused_factor_syrk_ref``, the plain PyTorch version with the same masked
semantics, so the host path and the card path run the same plan.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _mask(panels: torch.Tensor, rows: torch.Tensor, ws: torch.Tensor):
    """The identity-extended panels rebuilt from the true extents: keep the
    lower triangle of [0,w)x[0,w) and the tail [Wp,Wp+m)x[0,w), zero the
    rest, ones on the diagonal for columns >= w."""
    Bp, Lp, Wp = panels.shape
    dev = panels.device
    r = torch.arange(Lp, device=dev)[None, :, None]
    c = torch.arange(Wp, device=dev)[None, None, :]
    w = ws.to(dev, torch.int64)[:, None, None]
    m = rows.to(dev, torch.int64)[:, None, None] - w
    keep = (c < w) & (((r < w) & (r >= c)) | ((r >= Wp) & (r < Wp + m)))
    a = torch.where(keep, panels, torch.zeros((), dtype=panels.dtype,
                                               device=dev))
    return torch.where((r == c) & (r >= w),
                       torch.ones((), dtype=panels.dtype, device=dev), a)


def fused_factor_syrk_ref(panels: torch.Tensor, rows: torch.Tensor,
                          ws: torch.Tensor):
    """Plain PyTorch version: mask, then batched ``torch.linalg.cholesky``,
    ``solve_triangular`` and a matmul.  Returns ``(fp, u)`` as the kernel
    does."""
    Bp, Lp, Wp = panels.shape
    a = _mask(panels, rows, ws)
    D = a[:, :Wp, :]
    L = torch.linalg.cholesky(D + torch.tril(D, -1).mT)
    if Lp == Wp:
        return L, panels.new_zeros((Bp, 0, 0))
    T = torch.linalg.solve_triangular(L, a[:, Wp:, :].mT, upper=False).mT
    return torch.cat([L, T], dim=1), torch.tril(T @ T.mT)


def fused_factor_syrk(panels: torch.Tensor, rows: torch.Tensor,
                      ws: torch.Tensor):
    """Factor a stacked group buffer in one kernel call.

    panels  (Bp, Lp, Wp) float64 raw packed panels: diagonal block in rows
            [0, w), tail rows at [Wp, Wp + rows - w); pad cells may hold
            anything
    rows/ws (Bp,) int32 true per-lane extents; pad lanes are (0, 0)

    Returns ``(fp, u)``: ``fp`` the factored panels in the same layout
    (identity extension in place, strict upper zero), ``u`` the
    (Bp, Lp-Wp, Lp-Wp) update matrices ``tril(T T^T)``, zero outside each
    lane's true (m, m).  ``fused_factor_syrk.launches`` counts the calls that
    launched the CUDA kernel.
    """
    if panels.device.type == "cpu":
        return fused_factor_syrk_ref(panels, rows, ws)
    if panels.device.type != "cuda":
        raise ValueError(f"unsupported device {panels.device}")
    if panels.dim() != 3 or panels.dtype != torch.float64:
        raise ValueError("panels must be a (Bp, Lp, Wp) float64 tensor")
    if not panels.is_contiguous():
        raise ValueError("panels must be contiguous")
    Bp, Lp, Wp = panels.shape
    if Lp < Wp or Wp < 1:
        raise ValueError(f"bad panel shape {tuple(panels.shape)}")
    for name, t in (("rows", rows), ("ws", ws)):
        if (t.device != panels.device or t.dtype != torch.int32
                or t.shape != (Bp,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({Bp},) int32 "
                             f"tensor on {panels.device}")
    fp = torch.empty_like(panels)
    u = panels.new_empty((Bp, Lp - Wp, Lp - Wp))
    lib = _build.load("fused_factor_syrk")
    rc = lib.fused_factor_syrk_launch(
        panels.data_ptr(), rows.data_ptr(), ws.data_ptr(), fp.data_ptr(),
        u.data_ptr(), Bp, Lp, Wp, panels.device.index or 0,
        torch.cuda.current_stream(panels.device).cuda_stream)
    _build.check(lib, "fused_factor_syrk_error", rc, "fused_factor_syrk")
    fused_factor_syrk.launches += 1
    return fp, u


fused_factor_syrk.launches = 0

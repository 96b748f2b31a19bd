"""Lower SYRK ``C = tril(A @ A^T)``.

``syrk_ln`` is the port of the TPU kernel
``src/repro/kernels/syrk.py::syrk_ln``.  On a CUDA tensor it launches the
hand-written kernel in ``csrc/syrk_ln.cu`` (see the note there); on a CPU
tensor it runs ``syrk_ln_ref``.  Edges are masked in the kernel, so the
operand is never padded.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def syrk_ln_ref(a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``tril(a @ a.T)``."""
    return torch.tril(a @ a.mT)


def syrk_ln(a: torch.Tensor) -> torch.Tensor:
    """``tril(a @ a^T)`` for a float64 ``a`` (M, K) with contiguous rows;
    returns a contiguous (M, M) tensor whose strict upper triangle is zero.
    ``syrk_ln.launches`` counts the calls that launched the CUDA kernel."""
    if a.device.type == "cpu":
        return syrk_ln_ref(a)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    _build.check_matrix("a", a, a.device)
    M, K = a.shape
    if M > 65535 * 64:
        raise ValueError(f"a has {M} rows; the kernel's grid takes at most "
                         f"{65535 * 64}")
    c = a.new_empty((M, M))
    if M == 0:
        return c
    lib = _build.load("syrk_ln")
    rc = lib.syrk_ln_launch(
        a.data_ptr(), _build.ld(a), c.data_ptr(), M, M, K,
        a.device.index or 0, _build.stream(a.device))
    _build.check(lib, "syrk_ln_error", rc, "syrk_ln")
    syrk_ln.launches += 1
    return c


syrk_ln.launches = 0

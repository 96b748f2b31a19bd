"""Lower SYRK ``C = tril(A @ A^T)``, and its subtract form ``C -= A @ A^T``
on and below the diagonal, in place.

``syrk_ln`` is the port of the TPU kernel
``src/repro/kernels/syrk.py::syrk_ln``.  On a CUDA tensor it launches the
hand-written kernel in ``csrc/syrk_ln.cu`` (see the note there); on a CPU
tensor it runs ``syrk_ln_ref``.  ``syrk_ln_sub`` is the same kernel's
subtract form, which only the blocked ``potrf`` routine's trailing update
uses (the reference writes it as ``trail - syrk_ln(X)``); its plain
version is ``syrk_ln_sub_ref``.  Edges are masked in the kernel, so the
operand is never padded.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def syrk_ln_ref(a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``tril(a @ a.T)``."""
    return torch.tril(a @ a.mT)


def syrk_ln_sub_ref(c: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the subtract form: ``c -= tril(a @ a.T)``
    in place (the strict upper triangle of ``c`` loses zeros); returns
    ``c``."""
    return c.sub_(torch.tril(a @ a.mT))


def _launch(a: torch.Tensor, c: torch.Tensor, sub: bool) -> None:
    """Check ``a`` (M, K) and ``c`` (M, M), then launch the plain or the
    subtract form of the kernel, counted on ``syrk_ln.launches``."""
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    _build.check_matrix("a", a, a.device)
    _build.check_matrix("c", c, a.device)
    M, K = a.shape
    if c.shape != (M, M):
        raise ValueError(f"c must be ({M}, {M}), got {tuple(c.shape)}")
    if M > 65535 * 64:
        raise ValueError(f"a has {M} rows; the kernel's grid takes at most "
                         f"{65535 * 64}")
    if M == 0:
        return
    lib = _build.load("syrk_ln")
    fn = lib.syrk_ln_sub_launch if sub else lib.syrk_ln_launch
    rc = fn(a.data_ptr(), _build.ld(a), c.data_ptr(), _build.ld(c), M, K,
            a.device.index or 0, _build.stream(a.device))
    _build.check(lib, "syrk_ln_error", rc, "syrk_ln")
    syrk_ln.launches += 1


def syrk_ln(a: torch.Tensor) -> torch.Tensor:
    """``tril(a @ a^T)`` for a float64 ``a`` (M, K) with contiguous rows;
    returns a contiguous (M, M) tensor whose strict upper triangle is zero.
    ``syrk_ln.launches`` counts the calls that launched the CUDA kernel, in
    either form."""
    if a.device.type == "cpu":
        return syrk_ln_ref(a)
    _build.check_matrix("a", a, a.device)
    c = a.new_empty((a.shape[0], a.shape[0]))
    _launch(a, c, sub=False)
    return c


def syrk_ln_sub(c: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``c -= a @ a^T`` on and below the diagonal of ``c``, in place, for
    float64 ``c`` (M, M) and ``a`` (M, K), both with contiguous rows (row
    and column slices of one matrix qualify); ``a`` must share no cell
    with ``c``.  On a card the strict upper triangle of ``c`` is never
    touched.  Returns ``c``."""
    if a.device.type == "cpu":
        return syrk_ln_sub_ref(c, a)
    _launch(a, c, sub=True)
    return c


syrk_ln.launches = 0

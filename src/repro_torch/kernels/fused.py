"""Fused batched supernode factorization: POTRF + TRSM + SYRK per lane.

``fused_factor_syrk`` is the port of the TPU kernel
``src/repro/kernels/fused.py::fused_factor_syrk``: unguarded, and with
``guard=True`` (``fused_factor_syrk_guarded``: the pivot clamp and the
per-lane status row).  On a CUDA tensor each launches its hand-written
kernel in ``csrc/fused_factor_syrk.cu`` (see the note there for the design
and its bound); on a CPU tensor each runs its plain PyTorch version
(``fused_factor_syrk_ref``, ``fused_factor_syrk_guarded_ref``) with the
same masked semantics, so the host path and the card path run the same
plan.  A failed pivot gives a nonfinite lane on both, never an exception.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: columns of the guarded kernel's per-lane status row (the reference's
#: ``STATUS_COLS``; its 128-wide row is a TPU lane artifact):
#:   0  min unclamped pivot d^2 over the lane's real columns (inf if none)
#:   1  number of pivots clamped
#:   2  nonfinite flag (1.0 if any live cell of the factored panel is not
#:      finite)
#:   3  total clamp magnitude sum(d2_clamped - d2)
STATUS_COLS = 4


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


def _nan_failed(L: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """NaN-fill every lane of ``L`` whose ``cholesky_ex`` reported a failed
    pivot (``info > 0``): the reference's xla lowering returns a NaN factor
    there and the card's kernels take the square root of a negative pivot,
    so a failed lane is nonfinite on every route and nothing raises."""
    bad = (info > 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.full((), float("nan"), dtype=L.dtype,
                                       device=L.device), L)


def _tail_mask(rows: torch.Tensor, ws: torch.Tensor, mp: int, dev):
    """(Bp, mp, mp) mask of each lane's true (m, m) update block."""
    m = (rows.to(dev, torch.int64) - ws.to(dev, torch.int64))[:, None, None]
    i = torch.arange(mp, device=dev)
    return (i[None, :, None] < m) & (i[None, None, :] < m)


def fused_factor_syrk_ref(panels: torch.Tensor, rows: torch.Tensor,
                          ws: torch.Tensor):
    """Plain PyTorch version: mask, then batched ``torch.linalg.cholesky_ex``
    (a lane with a failed pivot comes out NaN, as on the card),
    ``solve_triangular`` and a matmul.  Returns ``(fp, u)`` as the kernel
    does."""
    Bp, Lp, Wp = panels.shape
    a = _mask(panels, rows, ws)
    D = a[:, :Wp, :]
    L, info = torch.linalg.cholesky_ex(D + torch.tril(D, -1).mT)
    L = _nan_failed(L, info)
    if Lp == Wp:
        return L, panels.new_zeros((Bp, 0, 0))
    T = torch.linalg.solve_triangular(L, a[:, Wp:, :].mT, upper=False).mT
    u = torch.tril(T @ T.mT)
    # a NaN tail row would reach the zero rows of the product (0 * NaN)
    u = torch.where(_tail_mask(rows, ws, Lp - Wp, panels.device), u,
                    u.new_zeros(()))
    return torch.cat([L, T], dim=1), u


def live_cells(rows: torch.Tensor, ws: torch.Tensor, Lp: int, Wp: int,
               dev) -> torch.Tensor:
    """(Bp, Lp, Wp) mask of each lane's live cells: the lower triangle of
    [0,w)x[0,w) and the tail [Wp,Wp+m)x[0,w).  They are the factor; the
    strict upper triangle is zero, and the other cells of a lane that broke
    (a nonfinite live cell) are unspecified: the kernels' trailing update
    can carry its NaN into them."""
    r = torch.arange(Lp, device=dev)[None, :, None]
    c = torch.arange(Wp, device=dev)[None, None, :]
    w = ws.to(dev, torch.int64)[:, None, None]
    m = rows.to(dev, torch.int64)[:, None, None] - w
    return (c < w) & (((r < w) & (r >= c)) | ((r >= Wp) & (r < Wp + m)))


def fused_factor_syrk_guarded_ref(panels: torch.Tensor, rows: torch.Tensor,
                                  ws: torch.Tensor, thr: float = 0.0):
    """Plain PyTorch version of the guarded kernel: a batched right-looking
    column loop that mirrors the reference's clamping xla chain
    (``engines.py::_one_factor_syrk_guarded``, ``clamp=True``) operation for
    operation.  For each real column k of a lane, with d2 its pivot before
    the square root and theta the largest |entry| below it:

        mind2  = d2 if d2 < mind2 (NaN-ignoring)
        gfloor = theta^2 * (GFLOOR_MULT / max(thr, 1e-300))
        clamp  = thr > 0 and (not d2 >= thr or not d2 >= gfloor)
        d2c    = max(thr, |d2|, gfloor), thr where that is not finite

    and a clamped pivot counts once and adds ``d2c - d2`` (``d2c`` for a
    nonfinite d2) to the magnitude.  ``thr = 0`` detects without clamping
    (``guard="raise"``).  Two differences from the reference's chain, both
    about cells no live cell reads: the rank-1 update touches only the
    columns right of k (the reference's full-width product also turns the
    finished cells of a row that holds an inf into NaN, inf * 0), and ``fp``
    and ``u`` keep only the live cells (``live_cells``) at the end.

    Returns ``(fp, u, st)`` with ``st`` (Bp, 4): min unclamped d2, n
    clamped, nonfinite flag (any nonfinite live cell), clamp magnitude; a
    pad lane gives (inf, 0, 0, 0)."""
    from repro_torch.core.guard import GFLOOR_MULT

    Bp, Lp, Wp = panels.shape
    dev, dt = panels.device, panels.dtype
    a = _mask(panels, rows, ws)
    r = torch.arange(Lp, device=dev)[None, :]
    w = ws.to(dev, torch.int64)
    thr_t = torch.tensor(float(thr), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    gscale = GFLOOR_MULT / max(float(thr), 1e-300)
    mind2 = torch.full((Bp,), float("inf"), dtype=dt, device=dev)
    ncl = torch.zeros(Bp, dtype=dt, device=dev)
    mag = torch.zeros(Bp, dtype=dt, device=dev)
    # columns at or past every lane's width are identity: nothing to do
    for k in range(int(w.max()) if Bp else 0):
        colk = a[:, :, k]
        d2 = colk[:, k]
        real = k < w
        mind2 = torch.where(real & (d2 < mind2), d2, mind2)
        theta = torch.where(r > k, colk.abs(), zero).amax(dim=1)
        gfloor = theta * theta * gscale
        cl = real & (float(thr) > 0) & (~(d2 >= thr_t) | ~(d2 >= gfloor))
        d2c = torch.maximum(torch.maximum(thr_t, d2.abs()), gfloor)
        d2c = torch.where(torch.isfinite(d2c), d2c, thr_t)
        ncl = ncl + torch.where(cl, 1.0, 0.0).to(dt)
        dmag = torch.where(torch.isfinite(d2), d2c - d2, d2c)
        mag = mag + torch.where(cl, dmag, zero)
        d2 = torch.where(cl, d2c, d2)
        dk = torch.sqrt(d2)
        below = torch.where(r > k, colk / dk[:, None], zero)
        if k + 1 < Wp:
            a[:, :, k + 1:] -= below[:, :, None] * below[:, None, k + 1:Wp]
        a[:, :, k] = torch.where(r == k, dk[:, None], below)
    live = live_cells(rows, ws, Lp, Wp, dev)
    nf = (~torch.isfinite(torch.where(live, a, zero))).flatten(1).any(1)
    # the kernel's layout: live cells, zeros, ones on the extension diagonal
    fp = torch.where(live, a, _mask(panels.new_zeros(()).expand_as(panels),
                                    rows, ws))
    st = torch.stack([mind2, ncl, nf.to(dt), mag], dim=1)
    if Lp == Wp:
        return fp, panels.new_zeros((Bp, 0, 0)), st
    T = fp[:, Wp:, :]
    u = torch.where(_tail_mask(rows, ws, Lp - Wp, dev), torch.tril(T @ T.mT),
                    zero)
    return fp, u, st


def _check_group(panels: torch.Tensor, rows: torch.Tensor,
                 ws: torch.Tensor) -> None:
    """Raise unless the arguments are what the CUDA kernels take."""
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


def fused_factor_syrk(panels: torch.Tensor, rows: torch.Tensor,
                      ws: torch.Tensor, *, guard: bool = False,
                      thr: float = 0.0):
    """Factor a stacked group buffer in one kernel call.

    panels  (Bp, Lp, Wp) float64 raw packed panels: diagonal block in rows
            [0, w), tail rows at [Wp, Wp + rows - w); pad cells may hold
            anything
    rows/ws (Bp,) int32 true per-lane extents; pad lanes are (0, 0)
    guard   also return the per-lane status ``st`` (Bp, 4) and clamp pivots
            at ``thr`` (an fp64 scalar; 0 detects without clamping): see
            ``fused_factor_syrk_guarded``.  ``guard=False`` is the unguarded
            kernel, with no detection work at all.

    Returns ``(fp, u)`` (``(fp, u, st)`` with ``guard``): ``fp`` the
    factored panels in the same layout (identity extension in place, strict
    upper zero), ``u`` the (Bp, Lp-Wp, Lp-Wp) update matrices
    ``tril(T T^T)``, zero outside each lane's true (m, m).
    ``fused_factor_syrk.launches`` counts the calls that launched the
    unguarded CUDA kernel.
    """
    if guard:
        return fused_factor_syrk_guarded(panels, rows, ws, thr)
    if panels.device.type == "cpu":
        return fused_factor_syrk_ref(panels, rows, ws)
    _check_group(panels, rows, ws)
    Bp, Lp, Wp = panels.shape
    fp = torch.empty_like(panels)
    u = panels.new_empty((Bp, Lp - Wp, Lp - Wp))
    if Bp == 0:  # nothing to launch: the plain version's empty outputs
        return fp, u
    # the panel launches' per-(slab, lane) counters, zeroed by the kernel
    nslab = -(-Wp // min(Wp, 64))
    cnt = torch.empty(nslab * Bp, dtype=torch.int32, device=panels.device)
    lib = _build.load("fused_factor_syrk")
    rc = lib.fused_factor_syrk_launch(
        panels.data_ptr(), rows.data_ptr(), ws.data_ptr(), fp.data_ptr(),
        u.data_ptr(), cnt.data_ptr(), Bp, Lp, Wp, panels.device.index,
        _build.stream(panels.device))
    _build.check(lib, "fused_factor_syrk_error", rc, "fused_factor_syrk")
    fused_factor_syrk.launches += 1
    return fp, u


fused_factor_syrk.launches = 0


def fused_factor_syrk_guarded(panels: torch.Tensor, rows: torch.Tensor,
                              ws: torch.Tensor, thr: float = 0.0):
    """The guarded kernel (the reference's ``fused_factor_syrk(...,
    guard=True, thr=)``): ``fused_factor_syrk`` plus the pivot clamp at
    ``thr`` and the per-lane status ``st`` (Bp, 4), columns as
    ``STATUS_COLS`` names them.  ``thr`` is fp64 (the reference's Pallas
    route ships it as a float32, its xla chain keeps fp64; the port follows
    the chain).  On a CUDA tensor it launches the guarded kernel of
    ``csrc/fused_factor_syrk.cu`` (each slab factored speculatively on the
    unguarded route, checked, and swept column by column only in the lanes
    that need it); on a CPU tensor it runs
    ``fused_factor_syrk_guarded_ref``.  ``fused_factor_syrk_guarded.launches``
    counts the launches; after a card call, ``guarded_sweeps()`` counts the
    (lane, slab) pairs that took the sweep."""
    thr = float(thr)
    if not (thr >= 0.0 and thr < float("inf")):
        raise ValueError(f"thr must be finite and >= 0, got {thr}")
    if panels.device.type == "cpu":
        return fused_factor_syrk_guarded_ref(panels, rows, ws, thr)
    _check_group(panels, rows, ws)
    from repro_torch.core.guard import GFLOOR_MULT

    Bp, Lp, Wp = panels.shape
    fp = torch.empty_like(panels)
    u = panels.new_empty((Bp, Lp - Wp, Lp - Wp))
    st = panels.new_empty((Bp, STATUS_COLS))
    if Bp == 0:  # nothing to launch: the plain version's empty outputs
        return fp, u, st
    nb = min(Wp, 64)
    nslab = -(-Wp // nb)
    # per (slab, lane): the panel counters (-1 after the call where the lane
    # took the sweep), the pivots and column maxima, and one slab's copy
    cnt = torch.empty(nslab * Bp, dtype=torch.int32, device=panels.device)
    gs = panels.new_empty(2 * nslab * Bp * nb)
    cpy = panels.new_empty((Bp, Lp, nb))
    lib = _build.load("fused_factor_syrk")
    rc = lib.fused_factor_syrk_guarded_launch(
        panels.data_ptr(), rows.data_ptr(), ws.data_ptr(), fp.data_ptr(),
        u.data_ptr(), st.data_ptr(), cnt.data_ptr(), gs.data_ptr(),
        cpy.data_ptr(), Bp, Lp, Wp, thr, GFLOOR_MULT, panels.device.index,
        _build.stream(panels.device))
    _build.check(lib, "fused_factor_syrk_error", rc,
                 "fused_factor_syrk_guarded")
    fused_factor_syrk_guarded.launches += 1
    fused_factor_syrk_guarded.counters = cnt
    return fp, u, st


fused_factor_syrk_guarded.launches = 0
fused_factor_syrk_guarded.counters = None


def guarded_sweeps() -> int:
    """The (lane, slab) pairs of the last card call of the guarded kernel
    that failed the check and took the column sweep (its counters hold -1
    there); 0 before any card call.  Synchronises with the card."""
    cnt = fused_factor_syrk_guarded.counters
    return 0 if cnt is None else int((cnt < 0).sum())

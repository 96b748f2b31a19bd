"""Bucket shapes of the level-scheduled path, free of torch.

A supernode panel of ``rows`` x ``w`` is padded into a ``(Lp, Wp)`` bucket so
that same-bucket supernodes of one etree level stack into one
``(Bp, Lp, Wp)`` group buffer.  The layout of a padded panel:

    [0   : w )   diagonal block D (lower triangle valid)
    [w   : Wp)   identity extension (keeps chol/trsm exact)
    [Wp  : Wp + rows - w)  tail rows (the rectangular part)
    [... : Lp)   zero padding

The schedule (``repro_torch.core.schedule``) and the device index plan
(``repro_torch.core.device_store``) import these functions from here, so the
host-side plan stack never imports the engine.  ``syrk_tile`` is the SYRK
column-tile width of the fused kernel, used by ``group_flop_stats``.
"""
from __future__ import annotations

import math


def _bucket(x: int, base: int = 128) -> int:
    """Geometric bucket family: 128, 256, 384, 512, 768, 1024, 1536, 2048, ..."""
    if x <= base:
        return base
    b = base
    while b < x:
        b *= 2
    return b


def _bucket_w(w: int) -> int:
    for c in (64, 128, 256, 512):
        if w <= c:
            return c
    return -(-w // 512) * 512


def _bucket_nb(nb: int) -> int:
    # coarse on purpose: every distinct (Lp, Wp, nrp, ncp) combination is a
    # separate compiled program in the reference's sequential RLB path
    for c in (64, 256, 1024, 4096):
        if nb <= c:
            return c
    return -(-nb // 4096) * 4096


def bucket_shape(rows: int, w: int) -> tuple[int, int]:
    """Padded (Lp, Wp) bucket of the sequential staging path (``"seq"``)."""
    Wp = _bucket_w(w)
    m = rows - w
    # Lp must also cover the largest padded RLB block
    Lp = _bucket(max(Wp + m, _bucket_nb(m) if m else 0))
    return Lp, Wp


def _bucket_batch(b: int) -> int:
    """Pad a batch count to the next power of two."""
    p = 1
    while p < b:
        p *= 2
    return p


def _bucket_w_fine(w: int) -> int:
    for c in (8, 16, 32, 64, 128, 256, 512):
        if w <= c:
            return c
    return -(-w // 512) * 512


def _bucket_qoct(x: int, base: int = 16) -> int:
    """Quarter-octave bucket family: 2^k * {1, 1.25, 1.5, 1.75} — padding
    overhead <= 25% per dimension at ~4x the bucket count of powers of two."""
    if x <= base:
        return base
    b = base
    while True:
        for f in (1.0, 1.25, 1.5, 1.75):
            v = int(b * f)
            if x <= v:
                return v
        b *= 2


def bucket_shape_batch(rows: int, w: int) -> tuple[int, int]:
    """Fine (Lp, Wp) bucket family (``"batch"``): for unmasked inner math,
    where every padded cell costs real flops."""
    Wp = _bucket_w_fine(w)
    return _bucket_qoct(Wp + rows - w), Wp


def _bucket_pow2(x: int, base: int) -> int:
    b = base
    while b < x:
        b *= 2
    return b


def bucket_shape_fused(rows: int, w: int) -> tuple[int, int]:
    """Coarse power-of-two (Lp, Wp) bucket family (``"fused"``) of the masked
    fused kernel, which skips pad lanes, identity-extension slabs and
    beyond-the-tail SYRK tiles, so padding costs memory but not flops."""
    Wp = _bucket_pow2(w, 8)
    return _bucket_pow2(Wp + rows - w, 16), Wp


def syrk_tile(mp: int, cap: int = 128) -> int:
    """SYRK column-tile width for a bucket tail of ``mp`` rows: the largest
    power of two <= ``cap`` dividing ``mp``.  Falls back to one full-width
    tile when ``mp`` is odd."""
    if mp <= 0:
        return 1
    tu = math.gcd(mp, cap)
    return mp if tu < 8 and tu != mp else tu

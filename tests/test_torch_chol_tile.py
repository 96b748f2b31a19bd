"""The blocked tile factor, the triangular SYRK grid and the restructured
``potrf`` routine, on the CPU.

``csrc/chol_tile.cu`` factors a tile in 8-wide sub-blocks (an rsqrt pivot,
the 8 x 8 inverse, the rows below and the trailing fragments, with warp 0
looking ahead), and ``csrc/syrk_ln.cu`` maps a linear block id to a tile on
or below the diagonal.  A CUDA kernel cannot run here, so these tests
replay each kernel's schedule in numpy, in the kernel's order and with its
index arithmetic, starting from NaN where the kernel's shared memory is
never written and where its output comes from ``torch.empty`` (a cell read
before it is written shows), and hold the result to the plain versions at
1e-12 relative.  The restructured ``potrf`` (one ``trsm_rlt`` and one
subtracting ``syrk_ln`` a step) is held, on the CPU, to the reference's
Pallas ``potrf`` in interpret mode with the reference's kernel-test
tolerance."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import (
    chol_tile,
    chol_tile_ref,
    ops,
    potrf_ref,
    syrk_ln_ref,
    syrk_ln_sub,
    syrk_ln_sub_ref,
)

SB = 8          # sub-block width (chol_tile.cu)
DT = 64         # SYRK tile edge (tile.cuh)
TILE_NS = [1, 2, 7, 8, 9, 16, 33, 63, 64, 65, 127, 128]


def _rel(x, ref):
    return float(np.max(np.abs(x - ref)) / max(np.max(np.abs(ref)), 1e-300))


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, n))
    return G @ G.T / n + 2.0 * np.eye(n), rng


def _variant(n):
    """(NP, warps) of the kernel's template for a tile of n."""
    NP = next(p for p in (8, 16, 32, 64, 128) if n <= p)
    return NP, (NP // 16 if NP >= 32 else 1)


def _factor_diag(S, J, inv):
    """Warp 0's 8 x 8 factor of sub-block J in place (rows as lanes, cells
    above the diagonal read and zeroed, never used), and its inverse."""
    j0 = J * SB
    a = S[j0:j0 + SB, j0:j0 + SB].copy()        # a[i] = lane i's registers
    i = np.arange(SB)
    rq = np.empty(SB)
    for q in range(SB):
        x = a[q, q]
        rq[q] = 1.0 / math.sqrt(x) if x > 0 else np.nan
        a[:, q] = np.where(i == q, x * rq[q],
                           np.where(i > q, a[:, q] * rq[q], 0.0))
        for p in range(q + 1, SB):
            upd = i >= p
            a[upd, p] -= a[upd, q] * a[p, q]
    S[j0:j0 + SB, j0:j0 + SB] = a
    if not inv:
        return None
    X = np.zeros((SB, SB))                  # column c = lane c's x[]
    for c in range(SB):                     # right-looking substitution
        x = np.eye(SB)[c]
        for r in range(SB):
            x[r] = 0.0 if r < c else x[r] * rq[r]
            x[r + 1:] -= a[r + 1:, r] * x[r]
        X[:, c] = x
    return X                                # D_J[p][c] = x_c[p]


def _warp_tasks(NW, ntask):
    """Each warp's trailing tasks, as the kernel's loops hand them out."""
    out = {0: [0] + ([1] if NW == 1 and ntask > 1 else [])}
    if NW == 1:
        out[0] += [t for s in range(2, ntask, 2) for t in (s, s + 1)]
    others = max(NW - 1, 1)
    for w in range(1, NW):
        out[w] = [t for s in range(w, ntask, 2 * others)
                  for t in (s, s + others)]
    return {w: [t for t in ts if t < ntask] for w, ts in out.items()}


def replay_chol_tile(A):
    """chol_tile.cu's schedule on the (n, n) lower triangle of A."""
    n = A.shape[0]
    NP, NW = _variant(n)
    nsb = -(-n // SB)
    nr = NP if NP < 16 else min(NP, -(-n // 16) * 16)
    S = np.full((NP, NP), np.nan)
    for i in range(nr):                       # lower triangle only
        for p in range(i + 1):
            S[i, p] = A[i, p] if i < n else float(p == i)
    D = {0: _factor_diag(S, 0, nsb > 1)}
    for J in range(nsb - 1):
        j0 = J * SB
        lo = j0 + SB
        mt0 = (lo // 16) * 16
        nmt = (nr - mt0) // 16
        assert 1 <= nmt <= NW                 # a warp per 16-row tile
        for w in range(nmt):                  # the rows below
            r0 = mt0 + 16 * w
            c = S[r0:r0 + 16, j0:j0 + SB] @ D[J].T
            keep = np.arange(r0, r0 + 16) >= lo
            S[r0:r0 + 16, j0:j0 + SB][keep] = c[keep]
        nnt = nsb - J - 1
        ntask = nmt * nnt
        tasks = _warp_tasks(NW, ntask)
        done = sorted(t for ts in tasks.values() for t in ts)
        assert done == list(range(ntask))     # every task once

        def trail(k):
            r0, c0 = mt0 + 16 * (k // nnt), lo + SB * (k % nnt)
            if r0 + 15 < c0:                   # above the diagonal
                return
            c = (S[r0:r0 + 16, c0:c0 + SB]
                 - S[r0:r0 + 16, j0:j0 + SB] @ S[c0:c0 + SB, j0:j0 + SB].T)
            r = np.arange(r0, r0 + 16)[:, None]
            cc = np.arange(c0, c0 + SB)[None, :]
            keep = (r >= lo) & (r >= cc)
            S[r0:r0 + 16, c0:c0 + SB][keep] = c[keep]

        trail(0)                               # warp 0: task 0 holds J + 1
        D[J + 1] = _factor_diag(S, J + 1, J + 2 < nsb)
        for t in range(1, ntask):
            trail(t)
    out = np.full((n, n), np.nan)
    for i in range(n):
        for p in range(n):
            out[i, p] = S[i, p] if p <= i else 0.0
    return out


@pytest.mark.parametrize("n", TILE_NS)
def test_chol_tile_schedule_matches_plain(n):
    M, rng = _spd(n, n)
    A = np.tril(M) + np.triu(np.full((n, n), np.nan), 1)  # never read
    L = replay_chol_tile(A)
    assert np.isfinite(L).all()
    want = chol_tile_ref(torch.from_numpy(np.tril(M))).numpy()
    assert _rel(L, want) <= 1e-12
    assert not np.triu(L, 1).any()


def test_chol_tile_schedule_nan_from_a_bad_pivot():
    M, _ = _spd(100, 3)
    M[40, 40] = -5.0
    L = replay_chol_tile(np.tril(M))
    assert np.isfinite(L[:40, :40]).all() and np.isnan(L[40, 40])


def test_chol_tile_out_is_in_place_on_cpu():
    M, _ = _spd(40, 5)
    big = torch.from_numpy(np.pad(np.tril(M), ((3, 1), (2, 5))))
    view = big[3:43, 2:42]
    want = chol_tile_ref(view.clone())
    before = chol_tile.launches
    assert chol_tile(view, out=view) is view
    assert torch.equal(view, want) and chol_tile.launches == before
    assert not big[:3].any() and not big[:, :2].any()


def tri_tile(t):
    """syrk_ln.cu's tri_tile: (rt, ct) of linear block t."""
    r = int((math.sqrt(8.0 * t + 1.0) - 1.0) * 0.5)
    while r * (r + 1) // 2 > t:
        r -= 1
    while (r + 1) * (r + 2) // 2 <= t:
        r += 1
    return r, t - r * (r + 1) // 2


def test_tri_tile_at_the_grid_limit():
    # the largest grid the wrapper allows: nt = 65535 tile rows
    for r in (1, 2, 3, 1000, 46340, 65533, 65534):
        T = r * (r + 1) // 2
        assert tri_tile(T - 1) == (r - 1, r - 1)
        assert tri_tile(T) == (r, 0)
        assert tri_tile(T + r) == (r, r)


def replay_syrk(a, c=None):
    """syrk_ln.cu's triangular grid over A (M, K): the plain form from NaN
    (torch.empty) when c is None, else the subtract form on c.  Counts the
    writes of each cell."""
    M = a.shape[0]
    nt = -(-M // DT)
    sub = c is not None
    C = c.copy() if sub else np.full((M, M), np.nan)
    writes = np.zeros((M, M), int)
    tiles = [tri_tile(t) for t in range(nt * (nt + 1) // 2)]
    assert sorted(tiles) == sorted((r, q) for r in range(nt)
                                   for q in range(r + 1))
    for rt, ct in tiles:
        r0, c0 = rt * DT, ct * DT
        if not sub and ct < rt:               # the mirror tile
            C[c0:c0 + DT, r0:r0 + DT] = 0.0
            writes[c0:c0 + DT, r0:r0 + DT] += 1
        acc = a[r0:r0 + DT] @ a[c0:c0 + DT].T
        r = np.arange(r0, min(r0 + DT, M))[:, None]
        cc = np.arange(c0, min(c0 + DT, M))[None, :]
        blk = C[r0:r0 + DT, c0:c0 + DT]
        if sub:
            blk[r >= cc] -= acc[r >= cc]
            writes[r0:r0 + DT, c0:c0 + DT] += r >= cc
        else:
            blk[...] = np.where(r >= cc, acc, 0.0)
            writes[r0:r0 + DT, c0:c0 + DT] += 1
    return C, writes


@pytest.mark.parametrize("M", [1, 63, 64, 65, 129, 1200])
def test_syrk_triangular_grid_matches_plain(M):
    rng = np.random.default_rng(M)
    a = rng.standard_normal((M, 7))
    C, writes = replay_syrk(a)
    assert (writes == 1).all()                 # every cell written once
    want = syrk_ln_ref(torch.from_numpy(a)).numpy()
    assert _rel(C, want) <= 1e-12
    assert not np.triu(C, 1).any()
    c0 = rng.standard_normal((M, M))
    Cs, ws = replay_syrk(a, c0)
    assert (ws == np.tril(np.ones((M, M), int))).all()
    assert np.array_equal(np.triu(Cs, 1), np.triu(c0, 1))  # untouched
    assert _rel(np.tril(Cs), np.tril(c0 - a @ a.T)) <= 1e-12


def test_syrk_ln_sub_plain_version():
    rng = np.random.default_rng(2)
    base = torch.from_numpy(rng.standard_normal((50, 60)))
    c, a = base[:, 10:60], base[:, :10]        # slices of one matrix
    want = c.clone() - torch.tril(a @ a.mT)
    assert syrk_ln_sub(c, a) is c
    assert torch.equal(c, want)
    assert torch.equal(syrk_ln_sub_ref(c.clone(), a), want - torch.tril(
        a @ a.mT))


@pytest.mark.parametrize("W", [130, 200, 257])
def test_restructured_potrf_matches_pallas(W):
    pytest.importorskip("jax")
    import repro.core  # noqa: F401  (turns on jax x64, as the package does)
    from repro.kernels import ops as rops

    M, rng = _spd(W, W)
    want = np.asarray(rops.potrf(M, backend="pallas"))
    Ag = np.tril(M) + np.triu(rng.standard_normal((W, W)), 1)
    A = torch.from_numpy(Ag)
    L = ops.potrf(A)
    np.testing.assert_allclose(L.numpy(), want, rtol=1e-11, atol=1e-10)
    assert not torch.triu(L, 1).any()
    assert torch.equal(A, torch.from_numpy(Ag))     # the input is kept
    np.testing.assert_allclose(potrf_ref(A).numpy(), want, rtol=1e-11,
                               atol=1e-10)

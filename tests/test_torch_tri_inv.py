"""The triangular kernels' block structure, on the CPU.

``csrc/tri_inv.cu`` inverts each lane by recursive doubling over 64-wide
blocks, and ``csrc/trsm_rlt.cu`` sweeps 64-wide block columns with each
diagonal block inverted in shared memory.  A CUDA kernel cannot run here,
so these tests replay each kernel's index arithmetic in numpy, tile by
tile with the kernel's K ranges (starting from NaN where the kernel's
output and scratch start from ``torch.empty``, so a cell read before it
is written shows), and hold the result against the plain versions to
1e-10 relative, at every doubling level, with odd carries and partial last
blocks.  ``tri_inv_launches``, which ``chip_smoke.py`` holds to the card's
trace, is held here to an independent count of the levels."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.trsm import (
    TRSM_NB as NB,
    tri_inv_launches,
    tri_inv_levels,
    tri_inv_lower,
    tri_inv_lower_ref,
    trsm_rlt_ref,
)

WIDTHS = [1, 63, 64, 65, 128, 129, 192, 256, 257, 669, 1024, 2048]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small ops, as in
    ``test_torch_train.py``: under the 6-worker test run each worker's
    thread pool spun at every op's barrier, and this file's tests took
    1.2-7x as long as with one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lower(W, seed):
    rng = np.random.default_rng(seed)
    L = np.tril(rng.standard_normal((W, W)) / np.sqrt(W))
    L[np.arange(W), np.arange(W)] = 1.0 + np.abs(rng.standard_normal(W))
    return L


def _rel(x, ref):
    return float(np.max(np.abs(x - ref)) / max(np.max(np.abs(ref)), 1e-300))


def _inv64(D):
    """tile.cuh's 64 x 64 inverse: the 8 x 8 diagonal inverses, then the
    doubling inv([A 0; C B]) = [A^-1 0; -B^-1 C A^-1  B^-1] at h = 8, 16,
    32, reading only D's lower blocks."""
    Li = np.zeros((NB, NB))
    for j0 in range(0, NB, 8):
        Li[j0:j0 + 8, j0:j0 + 8] = np.linalg.inv(np.tril(D[j0:j0 + 8,
                                                           j0:j0 + 8]))
    for h in (8, 16, 32):
        for base in range(0, NB, 2 * h):
            a, b = slice(base, base + h), slice(base + h, base + 2 * h)
            Li[b, a] = -Li[b, b] @ (D[b, a] @ Li[a, a])
    return Li


def _padded_diag(L, j0):
    """L's diagonal block at j0, padded to 64 x 64 with the identity."""
    n = min(NB, L.shape[0] - j0)
    D = np.eye(NB)
    D[:n, :n] = L[j0:j0 + n, j0:j0 + n]
    return D, n


def _tri_inv_blocked(L):
    """tri_inv.cu's launches on one lane: inv_diag_kernel, then per level
    level_t_kernel and level_x_kernel over every 64 x 64 tile of every
    pair."""
    Wp = L.shape[0]
    X = np.full((Wp, Wp), np.nan)
    for j0 in range(0, Wp, NB):
        D, n = _padded_diag(L, j0)
        X[j0:j0 + n, j0:j0 + n] = _inv64(D)[:n, :n]
    levels = tri_inv_levels(Wp)
    ts = max((h * h * n for h, n in levels), default=0)
    for h, npairs in levels:
        g = h // NB
        T = np.full(max(ts, 1), np.nan)
        tiles = [(p, rt, ct) for p in range(npairs) for rt in range(g)
                 for ct in range(g)]
        for p, rt, ct in tiles:                       # level_t_kernel
            s0 = 2 * p * h
            s1, e2 = s0 + h, min(s0 + 2 * h, Wp)
            r0, c0 = s1 + rt * NB, s0 + ct * NB
            if r0 >= e2:
                continue
            nr = min(NB, e2 - r0)
            Tp = T[p * h * h:(p + 1) * h * h].reshape(h, h)
            Tp[rt * NB:rt * NB + nr, ct * NB:ct * NB + NB] = (
                L[r0:r0 + nr, c0:s1] @ X[c0:s1, c0:c0 + NB])
        for p, rt, ct in tiles:                       # level_x_kernel
            s0 = 2 * p * h
            s1, e2 = s0 + h, min(s0 + 2 * h, Wp)
            r0, c0 = s1 + rt * NB, s0 + ct * NB
            if r0 >= e2:
                continue
            nr = min(NB, e2 - r0)
            K = r0 + nr - s1
            Tp = T[p * h * h:(p + 1) * h * h].reshape(h, h)
            X[r0:r0 + nr, c0:c0 + NB] = -(X[r0:r0 + nr, s1:s1 + K]
                                          @ Tp[:K, ct * NB:ct * NB + NB])
            X[c0:c0 + NB, r0:r0 + nr] = 0.0
    return X


def _levels_by_merging(Wp):
    """The doubling's levels counted by merging neighbouring groups of
    blocks until one is left: (h, pairs merged) per level."""
    groups = [[j] for j in range(-(-Wp // NB))]
    out = []
    while len(groups) > 1:
        h = NB * len(groups[0])
        merged = [groups[i] + groups[i + 1]
                  for i in range(0, len(groups) - 1, 2)]
        out.append((h, len(merged)))
        groups = merged + ([groups[-1]] if len(groups) % 2 else [])
    return out


@pytest.mark.parametrize("Wp", WIDTHS)
def test_tri_inv_launch_formula(Wp):
    assert tri_inv_levels(Wp) == _levels_by_merging(Wp)
    levels = len(_levels_by_merging(Wp))
    assert tri_inv_launches(Wp) == 1 + 2 * levels
    if Wp == 2048:
        assert tri_inv_launches(Wp) <= 12


@pytest.mark.parametrize("Wp", WIDTHS)
def test_tri_inv_blocked_matches_plain(Wp):
    L = _lower(Wp, Wp)
    X = _tri_inv_blocked(L + np.triu(np.full((Wp, Wp), np.nan), 1))
    assert not np.isnan(X).any()          # every cell written, none read early
    assert not np.triu(X, 1).any()
    want = tri_inv_lower_ref(torch.from_numpy(L)[None])[0].numpy()
    assert _rel(X, want) <= 1e-10


def _trsm_blocked(L, B):
    """trsm_rlt.cu on all rows: per 64-wide step, T = B_j - X_{<j}
    L[j, <j]^T, then X_j = T (D_j^-1)^T with D_j^-1 from the padded 64 x 64
    inverse."""
    M, W = B.shape
    X = np.full((M, W), np.nan)
    for j0 in range(0, W, NB):
        D, n = _padded_diag(L, j0)
        T = B[:, j0:j0 + n] - X[:, :j0] @ L[j0:j0 + n, :j0].T
        X[:, j0:j0 + n] = T @ _inv64(D)[:n, :n].T
    return X


@pytest.mark.parametrize("M", [1, 17])
@pytest.mark.parametrize("W", [1, 63, 65, 130, 669])
def test_trsm_blocked_matches_plain(M, W):
    L = _lower(W, W + 1)
    B = np.random.default_rng(M).standard_normal((M, W))
    X = _trsm_blocked(L + np.triu(np.full((W, W), np.nan), 1), B)
    want = trsm_rlt_ref(torch.from_numpy(L), torch.from_numpy(B)).numpy()
    assert _rel(X, want) <= 1e-10


def test_tri_inv_lower_takes_a_strided_view_on_the_cpu():
    # invert_diag passes P[:, :Wp, :] of a (Bp, Lp, Wp) group, not a copy
    Wp, Lp = 70, 100
    P = torch.from_numpy(np.stack([np.vstack([_lower(Wp, s),
                                              np.ones((Lp - Wp, Wp))])
                                   for s in range(3)]))
    X = tri_inv_lower(P[:, :Wp, :])
    assert torch.equal(X, tri_inv_lower_ref(P[:, :Wp, :].contiguous()))

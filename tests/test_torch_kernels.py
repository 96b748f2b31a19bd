"""The port's kernel plain versions against the reference's Pallas kernels in
interpret mode: ``fused_factor_syrk_ref`` against
``repro.kernels.fused.fused_factor_syrk``, ``tri_inv_lower_ref`` against
``repro.kernels.ops.trsm_lln(L, I)``, and the sequential path's
``gemm_nt_ref``, ``syrk_ln_ref``, ``trsm_rlt_ref`` (also through the port's
``ops.trsm_lln`` / ``ops.trsm_llt`` routes), ``potrf_ref``, the blocked
``potrf`` routine and ``ops.factor_panel`` against the Pallas kernels behind
``repro.kernels.ops``.  Tolerances are those of the reference's own kernel
tests (tests/test_fused.py, tests/test_kernels.py): 1e-12 on the factored
panels and the inverse, 1e-11 on the update matrices, and rtol 1e-11 /
atol 1e-10 on the fp64 sweeps.  Ragged shapes (not multiples of 64 or 128)
are the point: the port's kernels mask edges where the reference pads."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import repro.core  # noqa: E402,F401  (turns on jax x64, as the package does)
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels.fused import fused_factor_syrk as pallas_fused  # noqa: E402

from repro_torch.kernels import (  # noqa: E402
    chol_tile,
    fused_factor_syrk,
    fused_factor_syrk_ref,
    gemm_nt,
    gemm_nt_ref,
    ops,
    potrf_ref,
    syrk_ln,
    syrk_ln_ref,
    tri_inv_lower,
    tri_inv_lower_ref,
    trsm_rlt,
    trsm_rlt_ref,
)


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


def _lanes(extents, Lp, Wp, garbage, seed=0):
    """Raw staged lanes: SPD diagonal block (lower triangle) and tail rows;
    pad cells zero, or random garbage when ``garbage``."""
    rng = np.random.default_rng(seed)
    out = []
    for r, w in extents:
        p = rng.standard_normal((Lp, Wp)) if garbage else np.zeros((Lp, Wp))
        if w:
            G = rng.standard_normal((w, w))
            D = G @ G.T + w * np.eye(w)
            lo = np.tril_indices(w)
            p[:w, :w][lo] = D[lo]
            p[Wp:Wp + r - w, :w] = rng.standard_normal((r - w, w))
        out.append(p)
    return np.stack(out)


@pytest.mark.parametrize("extents,Lp,Wp,nb,garbage", [
    # ragged lanes, a width-1 lane and a pad lane, garbage in every pad cell
    ([(20, 8), (16, 16), (9, 1), (0, 0)], 32, 16, 128, True),
    # rows == w everywhere: mp == 0
    ([(8, 8), (5, 5)], 8, 8, 128, False),
    # width-1 lanes only
    ([(6, 1), (1, 1), (3, 1)], 16, 8, 128, False),
    # several slabs with a small nb, ragged widths across slab edges
    ([(40, 20), (33, 32), (10, 3)], 64, 32, 8, True),
    # odd tail: one full-width SYRK tile
    ([(19, 3)], 21, 4, 128, False),
])
def test_fused_ref_matches_pallas(extents, Lp, Wp, nb, garbage):
    panels = _lanes(extents, Lp, Wp, garbage)
    rows = np.array([r for r, _ in extents], np.int32)
    ws = np.array([w for _, w in extents], np.int32)
    efp, eu = pallas_fused(panels, rows, ws, nb=nb, interpret=True)
    fp, u = fused_factor_syrk_ref(torch.from_numpy(panels),
                                  torch.from_numpy(rows), torch.from_numpy(ws))
    assert fp.shape == (len(extents), Lp, Wp)
    assert u.shape == (len(extents), Lp - Wp, Lp - Wp)
    np.testing.assert_allclose(fp.numpy(), np.asarray(efp), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(u.numpy(), np.asarray(eu), rtol=1e-11,
                               atol=1e-11)


def test_fused_wrapper_on_cpu_is_the_plain_version():
    extents, Lp, Wp = [(40, 20), (33, 32), (10, 3), (0, 0)], 64, 32
    panels = torch.from_numpy(_lanes(extents, Lp, Wp, True, seed=3))
    rows = torch.tensor([r for r, _ in extents], dtype=torch.int32)
    ws = torch.tensor([w for _, w in extents], dtype=torch.int32)
    before = fused_factor_syrk.launches
    fp, u = fused_factor_syrk(panels, rows, ws)
    fr, ur = fused_factor_syrk_ref(panels, rows, ws)
    assert torch.equal(fp, fr) and torch.equal(u, ur)
    assert fused_factor_syrk.launches == before  # no kernel launched
    # the pad lane is an identity panel with a zero update
    assert torch.equal(fp[3], torch.eye(Lp, Wp, dtype=torch.float64))
    assert not u[3].any()
    # strict upper triangle zero, garbage masked away
    assert not torch.triu(fp[:, :Wp, :], 1).any()
    clean = torch.from_numpy(_lanes(extents, Lp, Wp, False, seed=3))
    for i, (r, w) in enumerate(extents):
        keep = torch.zeros(Lp, Wp, dtype=torch.bool)
        keep[:w, :w] = torch.ones(w, w, dtype=torch.bool).tril()
        keep[Wp:Wp + r - w, :w] = True
        clean[i][keep] = panels[i][keep]
    fc, uc = fused_factor_syrk_ref(clean, rows, ws)
    assert torch.equal(fc, fp) and torch.equal(uc, u)


def _lower(W, seed):
    rng = np.random.default_rng(seed)
    L = np.tril(rng.standard_normal((W, W)) / np.sqrt(W))
    L[np.arange(W), np.arange(W)] = 1.0 + np.abs(rng.standard_normal(W))
    return L


@pytest.mark.parametrize("W", [16, 40])
def test_tri_inv_ref_matches_pallas(W):
    Ls = np.stack([_lower(W, s) for s in range(2)])
    # garbage above the diagonal must be ignored
    Lg = Ls + np.triu(np.random.default_rng(9).standard_normal((W, W)), 1)
    X = tri_inv_lower_ref(torch.from_numpy(Lg))
    assert not torch.triu(X, 1).any()
    for b in range(2):
        ref = np.asarray(rops.trsm_lln(Ls[b], np.eye(W), backend="pallas"))
        np.testing.assert_allclose(X[b].numpy(), ref, rtol=1e-12, atol=1e-12)
    assert torch.equal(tri_inv_lower(torch.from_numpy(Lg)), X)


FP64 = {"rtol": 1e-11, "atol": 1e-10}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _spd_lower(W, seed):
    """An SPD matrix given by its lower triangle, garbage above it."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((W, W))
    A = M @ M.T / W + 2.0 * np.eye(W)
    return np.tril(A), np.tril(A) + np.triu(rng.standard_normal((W, W)), 1)


@pytest.mark.parametrize("m,k,n", [(137, 260, 90), (257, 130, 257)])
def test_gemm_nt_ref_matches_pallas(m, k, n):
    rng = np.random.default_rng(m)
    a, b = rng.standard_normal((m, k)), rng.standard_normal((n, k))
    want = np.asarray(rops.gemm_nt(a, b, backend="pallas"))
    got = gemm_nt_ref(_t(a), _t(b))
    np.testing.assert_allclose(got.numpy(), want, **FP64)
    before = gemm_nt.launches
    assert torch.equal(gemm_nt(_t(a), _t(b)), got)
    assert gemm_nt.launches == before  # the CPU runs the plain version


@pytest.mark.parametrize("m,k", [(137, 260), (257, 130)])
def test_syrk_ln_ref_matches_pallas(m, k):
    a = np.random.default_rng(m).standard_normal((m, k))
    want = np.asarray(rops.syrk_ln(a, backend="pallas"))
    got = syrk_ln_ref(_t(a))
    np.testing.assert_allclose(got.numpy(), want, **FP64)
    assert not torch.triu(got, 1).any()
    assert torch.equal(syrk_ln(_t(a)), got)


@pytest.mark.parametrize("m,w", [(137, 200), (257, 130)])
def test_trsm_rlt_ref_matches_pallas(m, w):
    rng = np.random.default_rng(w)
    L = np.tril(rng.standard_normal((w, w))) + w * np.eye(w)
    Lg = L + np.triu(rng.standard_normal((w, w)), 1)  # never read
    B = rng.standard_normal((m, w))
    want = np.asarray(rops.trsm_rlt(L, B, backend="pallas"))
    got = trsm_rlt_ref(_t(Lg), _t(B))
    np.testing.assert_allclose(got.numpy(), want, **FP64)
    assert torch.equal(trsm_rlt(_t(Lg), _t(B)), got)
    # the left-side routes: transpose (L X = C) and persymmetric flip
    # (L^T X = C), C (w, 60)
    C = rng.standard_normal((w, 60))
    for port, name in ((ops.trsm_lln, "trsm_lln"), (ops.trsm_llt, "trsm_llt")):
        want = np.asarray(getattr(rops, name)(L, C, backend="pallas"))
        np.testing.assert_allclose(port(_t(Lg), _t(C)).numpy(), want, **FP64)


@pytest.mark.parametrize("w", [200, 130])
def test_potrf_matches_pallas(w):
    A, Ag = _spd_lower(w, w)
    want = np.asarray(rops.potrf(A + np.tril(A, -1).T, backend="pallas"))
    np.testing.assert_allclose(potrf_ref(_t(Ag)).numpy(), want, **FP64)
    # the blocked routine on the CPU (two 128-column steps, a ragged last
    # tile) runs the kernels' plain versions
    before = chol_tile.launches
    L = ops.potrf(_t(Ag))
    np.testing.assert_allclose(L.numpy(), want, **FP64)
    assert not torch.triu(L, 1).any()
    assert chol_tile.launches == before


def test_factor_panel_matches_pallas():
    rows, w = 300, 150
    A, Ag = _spd_lower(w, 5)
    tail = np.random.default_rng(6).standard_normal((rows - w, w))
    want = np.asarray(rops.factor_panel(np.vstack([A, tail]), w,
                                        backend="pallas"))
    got = ops.factor_panel(_t(np.vstack([Ag, tail])), w)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-9)

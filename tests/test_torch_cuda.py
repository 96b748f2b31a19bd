"""Kernel checks that need an NVIDIA card (marker ``cuda``; skipped without
one).  Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each CUDA kernel is held against its plain PyTorch version at small odd
shapes the main path does not reach (partial 64-wide blocks, Wp not a power
of two, garbage pad cells and garbage above the diagonal, strided row and
column slices), to 1e-10 relative; the wrappers' argument checks raise; and
small factorizations on the card — the levels path and the sequential and
mixed routes, the guarded levels path and ``cholesky_many`` — match the
CPU run.  The guarded kernel is held against its plain version on groups
with indefinite lanes and a zero pivot under large off-diagonals, with
and without a clamp threshold; a negative pivot gives NaN on every
factor kernel, never a hang or garbage."""
import numpy as np
import pytest
import torch

from repro_torch.core import (
    BreakdownError,
    DeviceEngine,
    cholesky,
    cholesky_many,
)
from repro_torch.kernels import (
    chol_tile,
    chol_tile_ref,
    fused_factor_syrk,
    fused_factor_syrk_guarded,
    fused_factor_syrk_guarded_ref,
    fused_factor_syrk_ref,
    gemm_nt,
    live_cells,
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
from repro_torch.sparse import kkt_like, laplacian_3d
from repro_torch.sparse.gen import kkt_saddle, neumann_laplacian

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(x, ref):
    return float((x - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


def _group(extents, Lp, Wp, seed):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((len(extents), Lp, Wp))
    for i, (r, w) in enumerate(extents):
        if w:
            G = rng.standard_normal((w, w))
            lo = np.tril_indices(w)
            p[i, :w, :w][lo] = (G @ G.T / w + 2 * np.eye(w))[lo]
    rows = np.array([r for r, _ in extents], np.int32)
    ws = np.array([w for _, w in extents], np.int32)
    return p, rows, ws


@pytest.mark.parametrize("extents,Lp,Wp", [
    ([(20, 8), (16, 16), (9, 1), (0, 0)], 32, 16),
    ([(8, 8), (5, 5)], 8, 8),
    ([(300, 100), (150, 64), (101, 99), (0, 0)], 320, 100),
    ([(700, 130), (257, 200)], 768, 256),
])
def test_fused_kernel_matches_plain(card, extents, Lp, Wp):
    p, rows, ws = (torch.from_numpy(a).to(card)
                   for a in _group(extents, Lp, Wp, 0))
    before = fused_factor_syrk.launches
    fp, u = fused_factor_syrk(p, rows, ws)
    torch.cuda.synchronize()
    assert fused_factor_syrk.launches == before + 1
    fr, ur = fused_factor_syrk_ref(p, rows, ws)
    assert _rel(fp, fr) <= 1e-10
    if Lp > Wp:
        assert _rel(u, ur) <= 1e-10


def test_fused_kernel_multi_slab_mixed_widths(card):
    # widths neither multiples of 64 nor equal across lanes, three slabs,
    # a lane exactly one slab wide, a pad lane, garbage in every pad cell
    extents, Lp, Wp = [(600, 190), (300, 130), (64, 64), (0, 0)], 640, 192
    p, rows, ws = (torch.from_numpy(a).to(card)
                   for a in _group(extents, Lp, Wp, 5))
    fp, u = fused_factor_syrk(p, rows, ws)
    torch.cuda.synchronize()
    fr, ur = fused_factor_syrk_ref(p, rows, ws)
    assert _rel(fp, fr) <= 1e-10 and _rel(u, ur) <= 1e-10
    eye = torch.eye(Wp, dtype=torch.float64, device=card)
    assert torch.equal(fp[3, :Wp], eye) and not u[3].any()


def test_fused_kernel_ill_conditioned_diagonal(card):
    # a graded diagonal block, diag(A) = logspace(0, -6): the panel solve
    # through the explicit inverse of each 64-wide diagonal block must still
    # agree with the plain version's triangular solve
    rng = np.random.default_rng(9)
    extents, Lp, Wp = [(300, 128), (200, 100)], 320, 128
    p, rows, ws = _group(extents, Lp, Wp, 9)
    w = 128
    G = rng.standard_normal((w, w))
    M = G @ G.T / w + 2 * np.eye(w)
    d = 1 / np.sqrt(np.diag(M))
    s = np.sqrt(np.logspace(0, -6, w))
    A = (s * d)[:, None] * M * (s * d)[None, :]
    lo = np.tril_indices(w)
    p[0, :w, :w][lo] = A[lo]
    p, rows, ws = (torch.from_numpy(a).to(card) for a in (p, rows, ws))
    fp, u = fused_factor_syrk(p, rows, ws)
    torch.cuda.synchronize()
    fr, ur = fused_factor_syrk_ref(p, rows, ws)
    assert _rel(fp, fr) <= 1e-10 and _rel(u, ur) <= 1e-10


@pytest.mark.parametrize("Bp,Wp", [(3, 8), (2, 40), (2, 64), (2, 100),
                                   (1, 300)])
def test_tri_inv_kernel_matches_plain(card, Bp, Wp):
    rng = np.random.default_rng(Wp)
    L = np.tril(rng.standard_normal((Bp, Wp, Wp)) / np.sqrt(Wp))
    idx = np.arange(Wp)
    L[:, idx, idx] = 1.0 + np.abs(rng.standard_normal((Bp, Wp)))
    L = torch.from_numpy(L).to(card)
    X = tri_inv_lower(L)
    torch.cuda.synchronize()
    assert _rel(X, tri_inv_lower_ref(L)) <= 1e-10
    assert not torch.triu(X, 1).any()


def test_wrappers_check_their_arguments(card):
    p = torch.zeros((2, 16, 8), dtype=torch.float64, device=card)
    r = torch.zeros(2, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        fused_factor_syrk(p, r.long(), r)
    with pytest.raises(ValueError):
        fused_factor_syrk(p.float(), r, r)
    with pytest.raises(ValueError):
        fused_factor_syrk(p.transpose(1, 2), r, r)
    with pytest.raises(ValueError):
        tri_inv_lower(p)


@pytest.mark.parametrize("make", [lambda: laplacian_3d(8),
                                  lambda: kkt_like(12)])
def test_small_factor_on_card_matches_cpu(card, make):
    A = make()
    Fg = cholesky(A, device_engine=DeviceEngine(device=card))
    Fc = cholesky(A, device="cpu", sym=Fg.sym)
    scale = np.abs(Fc.store.storage).max()
    assert np.abs(Fg.store.storage - Fc.store.storage).max() <= 1e-10 * scale
    b = np.random.default_rng(0).standard_normal((A.shape[0], 2))
    x = Fg.solve(b, backend="device")
    assert np.linalg.norm(A @ x - b) <= 1e-10 * np.linalg.norm(b)


def _randn(shape, seed, dev):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float64).to(dev)


def _spd_garbage(W, seed, dev):
    """SPD lower triangle with garbage above the diagonal."""
    G = _randn((W, W), seed, dev)
    A = G @ G.mT / W + 2 * torch.eye(W, dtype=torch.float64, device=dev)
    return torch.tril(A) + torch.triu(_randn((W, W), seed + 1, dev), 1)


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (63, 7, 65), (137, 260, 90),
                                   (300, 129, 2)])
def test_gemm_nt_kernel_matches_plain(card, m, k, n):
    big = _randn((m + n + 3, k + 5), m, card)
    for a, b in ((big[:m, :k], big[m:m + n, 2:k + 2]),   # strided slices
                 (big[:m, :k].contiguous(), big[3:n + 3, 5:].contiguous())):
        before = gemm_nt.launches
        c = gemm_nt(a, b)
        torch.cuda.synchronize()
        assert gemm_nt.launches == before + 1
        assert _rel(c, gemm_nt_ref(a, b)) <= 1e-10


@pytest.mark.parametrize("k", [1, 3, 4, 5, 8, 17])
def test_gemm_nt_short_k(card, k):
    # K below, at and just past the tile's 4-deep MMA step and 16-deep chunk
    a, b = _randn((70, k), k, card), _randn((45, k), k + 100, card)
    c = gemm_nt(a, b)
    torch.cuda.synchronize()
    assert _rel(c, gemm_nt_ref(a, b)) <= 1e-10


@pytest.mark.parametrize("which", ["a", "b", "both"])
@pytest.mark.parametrize("ld,off", [(37, 1), (38, 1), (39, 0), (40, 3)])
def test_gemm_nt_odd_ld_and_offset(card, which, ld, off):
    # an odd leading dimension or an odd-element base offset on either
    # operand: the kernel must fall back to 8-byte copies for that operand
    m, n, k = 90, 70, 34   # k even: the contiguous operand copies 16 bytes
    big = _randn((m + n + 2, ld), ld + off, card)
    odd_a = big[:m, off:off + k]
    odd_b = big[m + 1:m + 1 + n, off:off + k]
    a = odd_a if which in ("a", "both") else odd_a.contiguous()
    b = odd_b if which in ("b", "both") else _randn((n, k), 5, card)
    c = gemm_nt(a, b)
    torch.cuda.synchronize()
    assert _rel(c, gemm_nt_ref(a, b)) <= 1e-10


@pytest.mark.parametrize("m,n", [(1, 65), (65, 1), (1, 1), (65, 65),
                                 (1, 130), (129, 65)])
def test_gemm_nt_thin_and_edge_shapes(card, m, n):
    a = _randn((m, 77), m, card)
    b = _randn((n, 77), 1000 + n, card)
    c = gemm_nt(a, b)
    torch.cuda.synchronize()
    assert c.shape == (m, n)
    assert _rel(c, gemm_nt_ref(a, b)) <= 1e-10


@pytest.mark.parametrize("m,k", [(1, 3), (65, 1), (137, 260), (200, 64)])
def test_syrk_ln_kernel_matches_plain(card, m, k):
    a = _randn((m, k + 3), k, card)[:, 1:k + 1]
    c = syrk_ln(a)
    torch.cuda.synchronize()
    assert _rel(c, syrk_ln_ref(a)) <= 1e-10
    assert not torch.triu(c, 1).any()


@pytest.mark.parametrize("n", [1, 5, 64, 100, 128])
def test_chol_tile_kernel_matches_plain(card, n):
    A = _spd_garbage(n + 2, n, card)[1:n + 1, 1:n + 1]  # strided, ld n + 2
    L = chol_tile(A)
    torch.cuda.synchronize()
    assert _rel(L, chol_tile_ref(A)) <= 1e-10
    assert not torch.triu(L, 1).any()


@pytest.mark.parametrize("W", [129, 200, 300])
def test_potrf_on_card_matches_plain(card, W):
    A = _spd_garbage(W, W, card)
    L = ops.potrf(A)
    torch.cuda.synchronize()
    assert _rel(L, potrf_ref(A)) <= 1e-10
    assert not torch.triu(L, 1).any()


@pytest.mark.parametrize("m,w", [(1, 1), (70, 64), (137, 200), (5, 130)])
def test_trsm_rlt_kernel_matches_plain(card, m, w):
    S = torch.tril(_spd_garbage(w, w, card))
    # torch's cholesky returns a column-major L; the kernel takes rows
    L = torch.linalg.cholesky(S + torch.tril(S, -1).mT).contiguous()
    Lg = L + torch.triu(_randn((w, w), 7, card), 1)  # never read
    B = _randn((m, w), m, card)
    before = (trsm_rlt.launches, tri_inv_lower.launches)
    X = trsm_rlt(Lg, B)
    torch.cuda.synchronize()
    assert (trsm_rlt.launches, tri_inv_lower.launches) == (before[0] + 1,
                                                           before[1] + 1)
    assert _rel(X, trsm_rlt_ref(L, B)) <= 1e-10
    C = _randn((w, 9), 3, card)
    assert _rel(ops.trsm_lln(Lg, C),
                torch.linalg.solve_triangular(L, C, upper=False)) <= 1e-10
    assert _rel(ops.trsm_llt(Lg, C),
                torch.linalg.solve_triangular(L.mT, C, upper=True)) <= 1e-10


@pytest.mark.parametrize("rows,w", [(300, 150), (40, 40), (500, 7)])
def test_factor_panel_on_card_matches_cpu(card, rows, w):
    P = _randn((rows, w), rows, card)
    P[:w] = torch.tril(_spd_garbage(w, w, card))
    got = ops.factor_panel(P, w)
    want = ops.factor_panel(P.cpu(), w)
    torch.cuda.synchronize()
    assert _rel(got.cpu(), want) <= 1e-10


def test_new_wrappers_check_their_arguments(card):
    a = torch.zeros((4, 3), dtype=torch.float64, device=card)
    with pytest.raises(ValueError):
        gemm_nt(a, a.float())
    with pytest.raises(ValueError):
        gemm_nt(a, a[:, :2])                     # inner dimensions differ
    with pytest.raises(ValueError):
        syrk_ln(a.mT)                            # columns not contiguous
    with pytest.raises(ValueError):
        syrk_ln(a[None])                         # not 2-D
    with pytest.raises(ValueError):
        chol_tile(torch.zeros((129, 129), dtype=torch.float64, device=card))
    with pytest.raises(ValueError):
        chol_tile(a)                             # not square
    with pytest.raises(ValueError):
        trsm_rlt(a[:3, :3], a[:, :2])            # B is not (M, 3)
    with pytest.raises(ValueError):
        trsm_rlt(a[:3], a[:, :3].float())


@pytest.mark.parametrize("kw", [
    {"schedule": "seq", "method": "rl"},
    {"schedule": "seq", "method": "rl", "fused": False},
    {"schedule": "seq", "method": "rlb", "fused": False},
    {"schedule": "seq", "method": "rlb", "batch_transfers": True},
    {"offload_threshold": 2000},
])
def test_seq_and_mixed_factor_on_card_match_cpu(card, kw):
    kw = dict(kw)
    fused = kw.pop("fused", True)
    A = laplacian_3d(10)
    Fg = cholesky(A, device_engine=DeviceEngine(device=card, fused=fused),
                  **kw)
    Fc = cholesky(A, device_engine=DeviceEngine(device="cpu", fused=fused),
                  sym=Fg.sym, **kw)
    assert Fg.stats == Fc.stats
    scale = max(np.abs(p).max() for p in Fc.panels)
    for pg, pc in zip(Fg.panels, Fc.panels):
        assert np.abs(pg - pc).max() <= 1e-10 * scale
    b = np.random.default_rng(1).standard_normal(A.shape[0])
    x = Fg.solve(b, backend="device")   # stages the host factor on the card
    assert Fg.dstore.eng.device.type == "cuda"
    assert np.linalg.norm(A @ x - b) <= 1e-10 * np.linalg.norm(b)


# ---------------------------------------------------------------------------
# the guarded kernel, NaN on a failed pivot, the guard and multi-matrix paths
# ---------------------------------------------------------------------------
def _breaking_group(extents, Lp, Wp, seed):
    """``_group`` with lane 1 indefinite (a negative pivot at column 2) and
    lane 2 with a zero pivot under large off-diagonals in column 0."""
    p, rows, ws = _group(extents, Lp, Wp, seed)
    p[1, 2, 2] = -3.0
    p[2, :, 0] = np.where(np.arange(Lp) < ws[2], 10.0, p[2, :, 0])
    p[2, 0, 0] = 0.0
    return p, rows, ws


def _same_nonfinite_and_close(x, ref, tol, live=None):
    if live is not None:  # the other cells of a broken lane: unspecified
        x, ref = x[live], ref[live]
    fin = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(x), fin)
    if fin.any():
        assert _rel(x[fin], ref[fin]) <= tol


@pytest.mark.parametrize("thr", [0.0, 2.0 ** -30, 0.25])
@pytest.mark.parametrize("extents,Lp,Wp", [
    ([(20, 8), (16, 16), (26, 12), (9, 1), (0, 0)], 32, 16),
    ([(300, 100), (150, 64), (101, 99), (0, 0)], 320, 100),
    ([(600, 130), (257, 200), (600, 256)], 768, 256),
])
def test_guarded_kernel_matches_plain(card, extents, Lp, Wp, thr):
    p, rows, ws = (torch.from_numpy(a).to(card)
                   for a in _breaking_group(extents, Lp, Wp, 1))
    before = (fused_factor_syrk.launches, fused_factor_syrk_guarded.launches)
    fp, u, st = fused_factor_syrk(p, rows, ws, guard=True, thr=thr)
    torch.cuda.synchronize()
    assert (fused_factor_syrk.launches,
            fused_factor_syrk_guarded.launches) == (before[0], before[1] + 1)
    fr, ur, sr = fused_factor_syrk_guarded_ref(p, rows, ws, thr)
    assert torch.equal(st[:, 1:3], sr[:, 1:3])   # clamp counts, flags
    assert torch.allclose(st[:, [0, 3]], sr[:, [0, 3]], rtol=1e-10, atol=0)
    _same_nonfinite_and_close(fp, fr, 1e-10,
                              live_cells(rows, ws, Lp, Wp, card))
    if Lp > Wp:
        _same_nonfinite_and_close(u, ur, 1e-10)
    if thr == 0:
        assert st[1, 2] == 1 and st[1, 0] < 0 and st[2, 2] == 1
    else:
        assert st[1, 1] >= 1 and st[2, 1] >= 1 and not st[:, 2].any()


def test_negative_pivot_gives_nan(card):
    p, rows, ws = (torch.from_numpy(a).to(card)
                   for a in _breaking_group([(300, 100), (150, 64),
                                             (101, 99)], 320, 100, 2))
    fp, u = fused_factor_syrk(p, rows, ws)
    torch.cuda.synchronize()
    assert torch.isfinite(fp[0]).all()
    for b in (1, 2):
        assert not torch.isfinite(fp[b]).all()
    A = _spd_garbage(100, 3, card)
    A[40, 40] = -5.0
    L = chol_tile(A)
    torch.cuda.synchronize()
    assert torch.isfinite(L[:40, :40]).all() and torch.isnan(L[40, 40])
    assert torch.isnan(chol_tile_ref(A)).all()


def test_guard_off_keeps_the_unguarded_launches(card):
    A = laplacian_3d(8)
    counts = []
    for guard in ("off", "raise"):
        before = (fused_factor_syrk.launches,
                  fused_factor_syrk_guarded.launches)
        F = cholesky(A, device_engine=DeviceEngine(device=card), guard=guard)
        nb = F.stats["schedule"]["batches"]
        counts.append((fused_factor_syrk.launches - before[0],
                       fused_factor_syrk_guarded.launches - before[1], nb))
    (u0, g0, nb), (u1, g1, _) = counts
    assert (u0, g0) == (nb, 0) and (u1, g1) == (0, nb)


@pytest.mark.parametrize("guard", ["raise", "perturb"])
def test_guarded_levels_on_card_match_cpu(card, guard):
    A = laplacian_3d(8) if guard == "raise" else neumann_laplacian(12)
    Fg = cholesky(A, device_engine=DeviceEngine(device=card), guard=guard)
    Fc = cholesky(A, device="cpu", sym=Fg.sym, guard=guard)
    rg, rc = Fg.guard_report, Fc.guard_report
    assert [(q["supernode"], q["n_clamped"]) for q in rg.perturbations] == \
        [(q["supernode"], q["n_clamped"]) for q in rc.perturbations]
    scale = np.abs(Fc.store.storage).max()
    assert np.abs(Fg.store.storage - Fc.store.storage).max() <= 1e-10 * scale
    b = np.asarray(A @ np.random.default_rng(0).standard_normal(A.shape[0]))
    x = Fg.solve(b, backend="device")
    assert np.linalg.norm(A @ x - b) <= 1e-10 * np.linalg.norm(b)
    with pytest.raises(BreakdownError) as eg:
        cholesky(kkt_saddle(8), device_engine=DeviceEngine(device=card),
                 guard="raise")
    with pytest.raises(BreakdownError) as ec:
        cholesky(kkt_saddle(8), device="cpu", guard="raise")
    assert [q["supernode"] for q in eg.value.report.broken] == \
        [q["supernode"] for q in ec.value.report.broken]


def test_cholesky_many_on_card_matches_cpu(card):
    import scipy.sparse as sp

    A = laplacian_3d(8)
    As = [sp.csc_matrix(A + s * sp.eye(A.shape[0])) for s in (0.0, 1.0, 2.5)]
    BG = cholesky_many(As, device_engine=DeviceEngine(device=card),
                       guard="raise")
    BC = cholesky_many(As, device="cpu", guard="raise")
    scale = np.abs(BC.storage).max()
    assert np.abs(BG.storage - BC.storage).max() <= 1e-10 * scale
    b = np.random.default_rng(2).standard_normal((3, A.shape[0], 2))
    x = BG.solve(b)
    xd = BG.solve(torch.from_numpy(b).to(card))
    assert xd.device.type == "cuda"
    assert np.abs(xd.cpu().numpy() - x).max() <= 1e-12 * np.abs(x).max()
    for i, Ai in enumerate(As):
        assert np.linalg.norm(Ai @ x[i] - b[i]) <= 1e-10 * np.linalg.norm(b[i])

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
    syrk_ln_sub,
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


def _lower_lanes(Bp, Wp, seed):
    rng = np.random.default_rng(seed)
    L = np.tril(rng.standard_normal((Bp, Wp, Wp)) / np.sqrt(Wp))
    idx = np.arange(Wp)
    L[:, idx, idx] = 1.0 + np.abs(rng.standard_normal((Bp, Wp)))
    return L


@pytest.mark.parametrize("Bp,Wp", [
    (3, 8), (2, 40), (2, 64), (2, 100), (1, 300),
    # every doubling level, odd carries (257, 669), partial last blocks
    (1, 1), (1, 63), (1, 64), (1, 65), (1, 128), (1, 129), (1, 192),
    (1, 256), (1, 257), (1, 669), (1, 1024), (1, 2048),
    # many narrow lanes
    (64, 8), (64, 40), (33, 64), (64, 100)])
def test_tri_inv_kernel_matches_plain(card, Bp, Wp):
    L = _lower_lanes(Bp, Wp, Wp)
    # garbage above the diagonal is never used
    Lg = torch.from_numpy(L + np.triu(np.random.default_rng(1).standard_normal(
        (Wp, Wp)), 1)).to(card)
    before = tri_inv_lower.launches
    X = tri_inv_lower(Lg)
    torch.cuda.synchronize()
    assert tri_inv_lower.launches == before + 1
    assert _rel(X, tri_inv_lower_ref(torch.from_numpy(L).to(card))) <= 1e-10
    assert not torch.triu(X, 1).any()


def test_tri_inv_kernel_lane_view(card):
    # engines.invert_diag passes P[:, :Wp, :] of a (Bp, Lp, Wp) group
    Bp, Lp, Wp = 3, 300, 130
    P = torch.from_numpy(np.concatenate(
        [_lower_lanes(Bp, Wp, 3), np.ones((Bp, Lp - Wp, Wp))], 1)).to(card)
    X = tri_inv_lower(P[:, :Wp, :])
    torch.cuda.synchronize()
    assert _rel(X, tri_inv_lower_ref(P[:, :Wp, :].contiguous())) <= 1e-10


def test_tri_inv_kernel_ill_conditioned_lane(card):
    # the factor of a graded matrix, diag(A) = logspace(0, -6), as in
    # test_fused_kernel_ill_conditioned_diagonal: the explicit inverses of
    # the 64-wide diagonal blocks and the products must still agree with
    # the plain version's triangular solve
    Wp = 300
    rng = np.random.default_rng(11)
    G = rng.standard_normal((Wp, Wp))
    M = G @ G.T / Wp + 2 * np.eye(Wp)
    d = 1 / np.sqrt(np.diag(M))
    s = np.sqrt(np.logspace(0, -6, Wp))
    L = np.linalg.cholesky((s * d)[:, None] * M * (s * d)[None, :])
    Lc = torch.from_numpy(np.stack([L, _lower_lanes(1, Wp, 2)[0]])).to(card)
    X = tri_inv_lower(Lc)
    torch.cuda.synchronize()
    assert _rel(X, tri_inv_lower_ref(Lc)) <= 1e-10


def test_tri_inv_kernel_nan_stays_in_its_lane(card):
    Bp, Wp = 4, 200
    L = _lower_lanes(Bp, Wp, 4)
    L[1, 150, 20] = np.nan
    Lc = torch.from_numpy(L).to(card)
    X = tri_inv_lower(Lc)
    torch.cuda.synchronize()
    assert torch.isnan(X[1]).any()
    keep = [0, 2, 3]
    assert torch.isfinite(X[keep]).all()
    assert _rel(X[keep], tri_inv_lower_ref(Lc[keep])) <= 1e-10


@pytest.mark.parametrize("guard", [False, True])
def test_fused_kernel_past_the_grid_y_limit(card, guard):
    # cholesky_many stacks M * Bp lanes into one call (M >= 257 full groups
    # of 256 pass 65,535): every launch of the fused kernel, guarded or
    # not, must take more lanes than a grid's y dimension
    Bp, Lp, Wp = 70_000, 20, 8
    rng = np.random.default_rng(70)
    ws = rng.integers(0, Wp + 1, Bp).astype(np.int32)
    rows = np.where(ws > 0, ws + rng.integers(0, Lp - Wp + 1, Bp),
                    0).astype(np.int32)
    G = rng.standard_normal((Bp, Wp, Wp))
    p = rng.standard_normal((Bp, Lp, Wp))
    p[:, :Wp] = G @ G.transpose(0, 2, 1) / Wp + 2 * np.eye(Wp)
    p, rows, ws = (torch.from_numpy(a).to(card) for a in (p, rows, ws))
    if guard:
        fp, u, st = fused_factor_syrk(p, rows, ws, guard=True, thr=1e-3)
        fr, ur, sr = fused_factor_syrk_guarded_ref(p, rows, ws, 1e-3)
        torch.cuda.synchronize()
        assert torch.equal(st[:, 1:3], sr[:, 1:3])
        assert torch.allclose(st[:, [0, 3]], sr[:, [0, 3]], rtol=1e-10,
                              atol=0)
    else:
        fp, u = fused_factor_syrk(p, rows, ws)
        fr, ur = fused_factor_syrk_ref(p, rows, ws)
        torch.cuda.synchronize()
    assert _rel(fp, fr) <= 1e-10 and _rel(u, ur) <= 1e-10


def test_tri_inv_kernel_past_the_grid_y_limit(card):
    # cholesky_many stacks M * Bp lanes into one call: more lanes than a
    # grid's y dimension takes (65,535) must launch
    Bp, Wp = 70_000, 8
    L = torch.from_numpy(_lower_lanes(Bp, Wp, 70)).to(card)
    X = tri_inv_lower(L)
    torch.cuda.synchronize()
    assert _rel(X, tri_inv_lower_ref(L)) <= 1e-10


@pytest.mark.parametrize("M", [1, 15, 16, 17, 33, 1200])
@pytest.mark.parametrize("W", [1, 63, 65, 130, 669])
def test_trsm_rlt_odd_ld_and_offsets(card, M, W):
    # B and L as slices at odd leading dimensions and odd row and column
    # offsets (8-byte copies), garbage above L's diagonal
    S = torch.tril(_spd_garbage(W, W, card))
    L = torch.linalg.cholesky(S + torch.tril(S, -1).mT)
    bigL = _randn((W + 3, W + 4), W, card)        # ld W + 4, offset (1, 3)
    bigL[1:W + 1, 3:W + 3] = L + torch.triu(_randn((W, W), 8, card), 1)
    Lv = bigL[1:W + 1, 3:W + 3]
    bigB = _randn((M + 2, W + 5), M + W, card)    # ld W + 5, offset (1, 1)
    Bv = bigB[1:M + 1, 1:W + 1]
    before = (trsm_rlt.launches, tri_inv_lower.launches)
    X = trsm_rlt(Lv, Bv)
    torch.cuda.synchronize()
    assert (trsm_rlt.launches, tri_inv_lower.launches) == (before[0] + 1,
                                                           before[1])
    assert _rel(X, trsm_rlt_ref(L, Bv)) <= 1e-10


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


TILE_NS = [1, 2, 7, 8, 9, 16, 33, 63, 64, 65, 127, 128]


@pytest.mark.parametrize("n", TILE_NS)
def test_chol_tile_kernel_odd_ld_and_offset(card, n):
    # a slice at leading dimension n + 9 and an odd offset (8-byte rows),
    # garbage above the diagonal; one launch per call
    A = _spd_garbage(n + 9, n, card)[3:n + 3, 5:n + 5]
    A[:] = _spd_garbage(n, n, card)
    before = chol_tile.launches
    L = chol_tile(A)
    torch.cuda.synchronize()
    assert chol_tile.launches == before + 1
    assert _rel(L, chol_tile_ref(A)) <= 1e-10
    assert not torch.triu(L, 1).any()
    # in place, as potrf calls it: only the slice is written
    big = A.clone()
    outer = _randn((n + 4, n + 6), n, card)
    outer[2:n + 2, 3:n + 3] = big
    view = outer[2:n + 2, 3:n + 3]
    frame = outer.clone()
    assert chol_tile(view, out=view) is view
    torch.cuda.synchronize()
    assert _rel(view, chol_tile_ref(big)) <= 1e-10
    frame[2:n + 2, 3:n + 3] = view
    assert torch.equal(outer, frame)


@pytest.mark.parametrize("n", [n for n in TILE_NS if n > 1])
def test_chol_tile_kernel_bad_pivot_gives_nan(card, n):
    # a non-positive pivot at column k: columns before it finite, NaN from
    # the pivot on, whichever sub-block and variant it falls in
    k = n // 2
    A = _spd_garbage(n, 11, card)
    A[k, k] = -1.0 if n % 2 else 0.0
    L = chol_tile(A)
    torch.cuda.synchronize()
    assert torch.isfinite(L[:, :k]).all() and torch.isnan(L[k, k])
    assert torch.isnan(chol_tile_ref(A)).all()


def _fill_cache_with_nan(n, card):
    """Leave a block of n NaNs in the caching allocator, so a following
    ``new_empty`` of that size starts from garbage, not zeros."""
    t = torch.full((n,), float("nan"), dtype=torch.float64, device=card)
    del t


@pytest.mark.parametrize("sliced", [True, False])
@pytest.mark.parametrize("M", [1, 64, 65, 1200])
@pytest.mark.parametrize("K", [1, 7, 8, 33, 669])
def test_syrk_ln_kernel_odd_ld_and_offset(card, M, K, sliced):
    # sliced: ld K + 5 at an odd offset (8-byte copies); else contiguous
    # (16-byte copies where K is even); c starts from NaN garbage
    a = (_randn((M + 3, K + 5), M + K, card)[2:M + 2, 1:K + 1] if sliced
         else _randn((M, K), M + K, card))
    _fill_cache_with_nan(M * M, card)
    before = syrk_ln.launches
    c = syrk_ln(a)
    torch.cuda.synchronize()
    assert syrk_ln.launches == before + 1
    assert _rel(c, syrk_ln_ref(a)) <= 1e-10
    assert torch.equal(torch.triu(c, 1), torch.zeros_like(c))


@pytest.mark.parametrize("M,K", [(1, 3), (65, 1), (200, 64), (300, 128)])
def test_syrk_ln_sub_kernel_leaves_the_upper_triangle(card, M, K):
    # c and a as potrf passes them: row and column slices of one matrix
    base = _randn((M + 1, K + M + 3), M, card)
    a, c = base[1:, 1:K + 1], base[1:, K + 2:K + 2 + M]
    c0, frame = c.clone(), base.clone()
    before = syrk_ln.launches
    assert syrk_ln_sub(c, a) is c
    torch.cuda.synchronize()
    assert syrk_ln.launches == before + 1
    assert torch.equal(torch.triu(c, 1), torch.triu(c0, 1))
    want = torch.tril(c0 - a @ a.mT)
    assert _rel(torch.tril(c), want) <= 1e-10
    frame[1:, K + 2:K + 2 + M] = c     # nothing outside c was written
    assert torch.equal(base, frame)


@pytest.mark.parametrize("W", [129, 256, 257, 700])
def test_potrf_on_card_launches_per_step(card, W):
    # one chol_tile per 128 columns; one trsm_rlt and one subtracting
    # syrk_ln per step below the last; nothing else
    A = _spd_garbage(W, W + 1, card)
    A0 = A.clone()
    names = ("chol_tile", "trsm_rlt", "syrk_ln", "gemm_nt", "tri_inv_lower")
    fns = (chol_tile, trsm_rlt, syrk_ln, gemm_nt, tri_inv_lower)
    before = [f.launches for f in fns]
    L = ops.potrf(A)
    torch.cuda.synchronize()
    steps = -(-W // 128)
    got = dict(zip(names, (f.launches - b for f, b in zip(fns, before))))
    assert got == {"chol_tile": steps, "trsm_rlt": steps - 1,
                   "syrk_ln": steps - 1, "gemm_nt": 0, "tri_inv_lower": 0}
    assert _rel(L, potrf_ref(A)) <= 1e-10
    assert not torch.triu(L, 1).any() and torch.equal(A, A0)


def test_out_and_subtract_forms_check_their_arguments(card):
    a = torch.zeros((4, 3), dtype=torch.float64, device=card)
    c = torch.zeros((4, 4), dtype=torch.float64, device=card)
    with pytest.raises(ValueError):
        syrk_ln_sub(c[:3, :3], a)                # c is not (M, M)
    with pytest.raises(ValueError):
        syrk_ln_sub(c[:3, :3], a.mT)             # a's columns not contiguous
    with pytest.raises(ValueError):
        chol_tile(c, out=c[:3, :3])              # out has another shape
    with pytest.raises(ValueError):
        trsm_rlt(c[:3, :3], a, out=c[:, :2])     # out has another shape


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
    # one launch, which inverts the diagonal blocks itself
    assert (trsm_rlt.launches, tri_inv_lower.launches) == (before[0] + 1,
                                                           before[1])
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


# ---------------------------------------------------------------------------
# the guarded route: speculative slabs, the check, the sweep where needed
# ---------------------------------------------------------------------------
def _swept_map(Bp, Wp):
    """(nslab, Bp) bool of the last guarded card call: the (slab, lane)
    pairs that took the column sweep."""
    from repro_torch.kernels.fused import fused_factor_syrk_guarded as g

    nslab = -(-Wp // min(Wp, 64))
    return (g.counters.view(nslab, Bp) < 0).cpu().numpy()


def _decoupled_lane(extents, Lp, Wp, seed, k, d2):
    """``_group`` with tails of half the size (so no column meets the
    growth floor at a perturb threshold) and lane 0's column k decoupled
    (zero off the diagonal, in the diagonal block and the tail), so its
    pivot is exactly d2."""
    p, rows, ws = _group(extents, Lp, Wp, seed)
    p[:, Wp:] *= 0.5
    w = ws[0]
    p[0, k, :k] = 0.0
    p[0, k + 1:w, k] = 0.0
    p[0, Wp:, k] = 0.0
    p[0, k, k] = d2
    return p, rows, ws


def _hold_guarded(p, rows, ws, thr, card):
    p, rows, ws = (torch.from_numpy(a).to(card) for a in (p, rows, ws))
    Bp, Lp, Wp = p.shape
    fp, u, st = fused_factor_syrk_guarded(p, rows, ws, thr)
    torch.cuda.synchronize()
    fr, ur, sr = fused_factor_syrk_guarded_ref(p, rows, ws, thr)
    assert torch.equal(st[:, 1:3], sr[:, 1:3])
    assert torch.allclose(st[:, [0, 3]], sr[:, [0, 3]], rtol=1e-10, atol=0)
    _same_nonfinite_and_close(fp, fr, 1e-10, live_cells(rows, ws, Lp, Wp,
                                                        card))
    _same_nonfinite_and_close(u, ur, 1e-10)
    return st, _swept_map(Bp, Wp)


def test_guarded_kernel_repairs_only_the_clamping_slab(card):
    # lane 0 clamps in its third slab only (a decoupled pivot at thr / 2):
    # slabs 1-2 stand as factored speculatively, slab 3 is swept
    thr = 5.46e-12
    p, rows, ws = _decoupled_lane([(300, 170), (250, 130), (0, 0)], 336, 192,
                                  3, 150, thr / 2)
    st, swept = _hold_guarded(p, rows, ws, thr, card)
    assert st[0, 1] == 1 and st[1, 1] == 0
    assert swept.tolist() == [[False, False, False], [False, False, False],
                              [True, False, False]]


@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_guarded_kernel_near_margin_pivot(card, sign):
    # a pivot at thr (1 -/+ 1e-10): clamped (-) or kept (+) by the sweep,
    # routed to it by the check's margin either way
    thr = 5.46e-12
    p, rows, ws = _decoupled_lane([(260, 150), (200, 120)], 288, 160, 4, 70,
                                  thr * (1.0 + sign * 1e-10))
    st, swept = _hold_guarded(p, rows, ws, thr, card)
    assert st[0, 1] == (1 if sign < 0 else 0)
    assert swept.tolist() == [[False, False], [True, False], [False, False]]


@pytest.mark.parametrize("thr", [0.0, 1e-3])
def test_guarded_kernel_spd_group_takes_no_sweep(card, thr):
    # an SPD group passes every check: the factor is the unguarded
    # kernel's, bit for bit, and no (lane, slab) is swept
    p, rows, ws = (torch.from_numpy(a).to(card) for a in _group(
        [(600, 190), (300, 130), (64, 64), (0, 0)], 640, 192, 5))
    fp, u, st = fused_factor_syrk_guarded(p, rows, ws, thr)
    f0, u0 = fused_factor_syrk(p, rows, ws)
    torch.cuda.synchronize()
    assert not _swept_map(4, 192).any()
    assert torch.equal(fp, f0) and torch.equal(u, u0)
    fr, ur, sr = fused_factor_syrk_guarded_ref(p, rows, ws, thr)
    assert torch.equal(st[:, 1:3], sr[:, 1:3])
    assert torch.allclose(st[:, [0, 3]], sr[:, [0, 3]], rtol=1e-10, atol=0)


@pytest.mark.parametrize("thr", [0.0, 1e-3])
def test_guarded_kernel_many_narrow_lanes(card, thr):
    # 70,000 narrow lanes (past the grid's y limit), some breaking: the
    # check and the sweep take one block per lane
    Bp, Lp, Wp = 70_000, 20, 8
    rng = np.random.default_rng(71)
    ws = rng.integers(0, Wp + 1, Bp).astype(np.int32)
    rows = np.where(ws > 0, ws + rng.integers(0, Lp - Wp + 1, Bp),
                    0).astype(np.int32)
    G = rng.standard_normal((Bp, Wp, Wp))
    p = rng.standard_normal((Bp, Lp, Wp))
    p[:, :Wp] = G @ G.transpose(0, 2, 1) / Wp + 2 * np.eye(Wp)
    p[::97, 3, 3] = -1.0                       # some indefinite lanes
    st, swept = _hold_guarded(p, rows, ws, thr, card)
    assert swept[0].sum() == ((ws[::97] > 3).sum())


def test_guarded_wrapper_launches_and_arguments(card):
    p, rows, ws = (torch.from_numpy(a).to(card) for a in _group(
        [(300, 100), (150, 64), (200, 90)], 320, 128, 6))
    for thr in (0.0, 1e-3):
        before = (fused_factor_syrk.launches,
                  fused_factor_syrk_guarded.launches)
        fused_factor_syrk(p, rows, ws, guard=True, thr=thr)
        torch.cuda.synchronize()
        assert (fused_factor_syrk.launches,
                fused_factor_syrk_guarded.launches) == (before[0],
                                                        before[1] + 1)
    # a lane view that is not contiguous is refused, as by the unguarded
    # kernel
    for guard in (False, True):
        with pytest.raises(ValueError, match="contiguous"):
            fused_factor_syrk(p[::2], rows[::2].contiguous(),
                              ws[::2].contiguous(), guard=guard)
        with pytest.raises(ValueError, match="contiguous"):
            fused_factor_syrk(p[:, :, :64], rows, ws, guard=guard)
    # no lanes: empty outputs, as on the CPU, and no launch
    e = p[:0]
    n = fused_factor_syrk_guarded.launches
    fp, u, st = fused_factor_syrk(e, rows[:0], ws[:0], guard=True, thr=1e-3)
    f0, u0 = fused_factor_syrk(e, rows[:0], ws[:0])
    assert fused_factor_syrk_guarded.launches == n
    assert (fp.shape, u.shape, st.shape) == ((0, 320, 128), (0, 192, 192),
                                             (0, 4))
    assert (f0.shape, u0.shape) == ((0, 320, 128), (0, 192, 192))


def test_cholesky_many_perturb_one_clamping_matrix_matches_cpu(card):
    import scipy.sparse as sp

    K = kkt_saddle(8)
    n = K.shape[0]
    Ks = []
    for s in (0.0, 10.0):        # same pattern; only the first clamps
        M = sp.csc_matrix(K + sp.eye(n))
        M.setdiag(K.diagonal() + s)
        Ks.append(M)
    BG = cholesky_many(Ks, device_engine=DeviceEngine(device=card),
                       guard="perturb")
    BC = cholesky_many(Ks, device="cpu", guard="perturb")
    for rg, rc in zip(BG.guard_reports, BC.guard_reports):
        assert [(q["supernode"], q["n_clamped"]) for q in rg.perturbations] \
            == [(q["supernode"], q["n_clamped"]) for q in rc.perturbations]
    assert BG.guard_reports[0].n_perturbed > 0
    assert BG.guard_reports[1].n_perturbed == 0
    b = np.ones(n)
    for i, Ai in enumerate(Ks):
        x = BG.factor(i).solve(b)
        assert np.linalg.norm(Ai @ x - b) <= 1e-10 * np.linalg.norm(b)


# ---------------------------------------------------------------------------
# the group fallback chain and the three-dispatch oracle on the card
# ---------------------------------------------------------------------------
def _storage(F):
    return F.store.storage


def test_failed_dispatch_steps_down_to_the_plain_tier(card):
    from repro_torch.core import engines
    from repro_torch.faults import FaultPlan

    A = laplacian_3d(10)
    clean = cholesky(A, device_engine=DeviceEngine(device=card),
                     guard="raise")
    eng = DeviceEngine(device=card)
    eng.faults = FaultPlan(fail_dispatch=2)
    steps = dict(engines.STEPS_DOWN)
    n = fused_factor_syrk_guarded.launches
    F = cholesky(A, device_engine=eng, guard="raise")
    groups = F.stats["schedule"]["batches"]
    assert eng.faults.fired[0][:2] == ("fail_dispatch", 2)
    assert eng.fallbacks == {"plain": 1, "host": 0, "failed": 0}
    assert engines.STEPS_DOWN["plain"] == steps["plain"] + 1
    # the failed group launched no kernel; the plain tier ran it instead
    assert fused_factor_syrk_guarded.launches == n + groups - 1
    assert F.guard_report.ok
    scale = np.max(np.abs(_storage(clean)))
    assert np.max(np.abs(_storage(F) - _storage(clean))) <= 1e-10 * scale


def test_plain_and_host_tiers_match_the_kernels(card):
    from repro_torch.faults import FaultPlan

    A = laplacian_3d(8)
    clean = cholesky(A, device_engine=DeviceEngine(device=card))
    scale = np.max(np.abs(_storage(clean)))
    eng = DeviceEngine(device=card)
    eng.faults = FaultPlan(fail_dispatch=1, fail_always=True)
    F = cholesky(A, device_engine=eng)
    groups = F.stats["schedule"]["batches"]
    assert eng.fallbacks == {"plain": groups, "host": 0, "failed": 0}
    assert np.max(np.abs(_storage(F) - _storage(clean))) <= 1e-10 * scale
    # with the plain tier down too, every group reaches the host tier
    eng = DeviceEngine(device=card)
    eng.faults = FaultPlan(fail_dispatch=1, fail_always=True)

    def plain_down(*_a, **_k):
        raise RuntimeError("plain tier down")

    eng._device_group = plain_down
    F = cholesky(A, device_engine=eng)
    assert eng.fallbacks == {"plain": groups, "host": groups, "failed": 0}
    assert np.max(np.abs(_storage(F) - _storage(clean))) <= 1e-10 * scale
    b = np.ones(A.shape[0])
    assert np.linalg.norm(A @ F.solve(b, backend="device") - b) <= \
        1e-10 * np.linalg.norm(b)


def test_kernel_error_is_raised_not_served_on_the_card(card, monkeypatch):
    from repro_torch.core import engines

    def refused(*_a, **_k):
        raise RuntimeError("wrapper refused the group")

    monkeypatch.setattr(engines, "fused_factor_syrk", refused)
    eng = DeviceEngine(device=card)
    steps = dict(engines.STEPS_DOWN)
    with pytest.raises(RuntimeError, match="refused"):
        cholesky(laplacian_3d(6), device_engine=eng, guard="raise")
    assert eng.fallbacks == {"plain": 0, "host": 0, "failed": 1}
    assert engines.STEPS_DOWN == steps


def test_kernel_build_error_is_not_absorbed_on_the_card(card, monkeypatch):
    from repro_torch.core import engines
    from repro_torch.kernels import KernelBuildError

    def no_build(*_a, **_k):
        raise KernelBuildError("nvcc not found")

    monkeypatch.setattr(engines, "fused_factor_syrk", no_build)
    eng = DeviceEngine(device=card)
    with pytest.raises(KernelBuildError):
        cholesky(laplacian_3d(6), device_engine=eng, guard="raise")
    assert eng.fallbacks == {"plain": 0, "host": 0, "failed": 0}


def test_three_dispatch_oracle_on_card(card):
    A = laplacian_3d(12)
    n = fused_factor_syrk.launches
    eng3 = DeviceEngine(device=card, fused_groups=False)
    F3 = cholesky(A, device_engine=eng3)
    batches = F3.stats["schedule"]["batches"]
    assert eng3.stats["device_calls"] == 3 * batches
    assert fused_factor_syrk.launches == n + batches
    F1 = cholesky(A, device_engine=DeviceEngine(device=card))
    for p3, p1 in zip(F3.panels, F1.panels):
        np.testing.assert_allclose(p3, p1, rtol=1e-12, atol=1e-12)
    Fc = cholesky(A, device_engine=DeviceEngine(device="cpu",
                                                fused_groups=False))
    scale = np.max(np.abs(_storage(Fc)))
    assert np.max(np.abs(_storage(F3) - _storage(Fc))) <= 1e-10 * scale


def test_ordered_cumsum_repeats_bit_for_bit_on_card(card):
    # torch.cumsum of one long fp64 row on the card changes its rounding
    # from run to run; the group assembly's scan must not
    from repro_torch.core.engines import ordered_cumsum

    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(2, 3_000_000, dtype=torch.float64, device=card,
                    generator=g)
    for rows in (x[:1], x):
        first = ordered_cumsum(rows)
        assert all(torch.equal(ordered_cumsum(rows), first)
                   for _ in range(10))
        err = float((first - torch.cumsum(rows, 1)).abs().max())
        assert err <= 1e-15 * float(rows.abs().sum(1).max())
    A = laplacian_3d(16)
    F1 = cholesky(A, device_engine=DeviceEngine(device=card))
    F2 = cholesky(A, device_engine=DeviceEngine(device=card))
    assert np.array_equal(_storage(F1), _storage(F2))

"""Synthetic SPD test-matrix generators.

The paper evaluates on 21 SuiteSparse matrices (n >= 600k) drawn from PDE
discretizations (CurlCurl_*, Flan_1565, Serena, Queen_4147, ...), structural
mechanics (audikw_1, Fault_639, Emilia_923, ...) and KKT systems (nlpkkt80/120).
SuiteSparse is not available offline, so we generate a suite from the same
matrix *families*: 2-D/3-D scalar Laplacians, 3-D vector elasticity (3 dof per
grid point, mimicking audikw/Fault/Emilia), and regularized KKT saddle systems
(mimicking nlpkkt*).  Sizes are scaled down so a single CPU core can factor
them, but the supernode statistics (supernode-size distribution, elimination
tree depth, fill ratio) follow the same shapes as the paper's suite.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _sym_csc(A: sp.spmatrix) -> sp.csc_matrix:
    A = sp.csc_matrix(A)
    A = (A + A.T) * 0.5
    A.sort_indices()
    return A


def laplacian_2d(nx: int, ny: int | None = None, *, stencil: int = 5) -> sp.csc_matrix:
    """2-D Dirichlet Laplacian on an nx-by-ny grid (5- or 9-point stencil)."""
    ny = ny or nx
    ex = np.ones(nx)
    ey = np.ones(ny)
    Tx = sp.diags([-ex[:-1], 2 * ex, -ex[:-1]], [-1, 0, 1])
    Ty = sp.diags([-ey[:-1], 2 * ey, -ey[:-1]], [-1, 0, 1])
    Ix, Iy = sp.eye(nx), sp.eye(ny)
    A = sp.kron(Iy, Tx) + sp.kron(Ty, Ix)
    if stencil == 9:
        Dx = sp.diags([-ex[:-1], ex * 0, -ex[:-1]], [-1, 0, 1])
        Dy = sp.diags([-ey[:-1], ey * 0, -ey[:-1]], [-1, 0, 1])
        A = A + 0.5 * sp.kron(Dy, Dx) + sp.eye(nx * ny) * 2.0
    return _sym_csc(A + 1e-3 * sp.eye(nx * ny))


def laplacian_3d(nx: int, ny: int | None = None, nz: int | None = None, *, stencil: int = 7) -> sp.csc_matrix:
    """3-D Dirichlet Laplacian on an nx*ny*nz grid (7- or 27-point stencil)."""
    ny = ny or nx
    nz = nz or nx

    def t(n):
        e = np.ones(n)
        return sp.diags([-e[:-1], 2 * e, -e[:-1]], [-1, 0, 1])

    Ix, Iy, Iz = sp.eye(nx), sp.eye(ny), sp.eye(nz)
    A = (
        sp.kron(Iz, sp.kron(Iy, t(nx)))
        + sp.kron(Iz, sp.kron(t(ny), Ix))
        + sp.kron(t(nz), sp.kron(Iy, Ix))
    )
    if stencil == 27:
        def b(n):  # full-bandwidth coupling
            e = np.ones(n)
            return sp.diags([e[:-1], e, e[:-1]], [-1, 0, 1])
        M = sp.kron(b(nz), sp.kron(b(ny), b(nx)))
        n = nx * ny * nz
        A = A + 0.05 * (sp.diags(np.asarray(M.sum(axis=1)).ravel()) - M)
    return _sym_csc(A + 1e-3 * sp.eye(nx * ny * nz))


def elasticity_3d(nx: int, ny: int | None = None, nz: int | None = None) -> sp.csc_matrix:
    """3-D linear-elasticity-like operator: 3 dofs per grid point with
    inter-component coupling (mimics audikw_1 / Fault_639 / Emilia_923)."""
    ny = ny or nx
    nz = nz or nx
    L = laplacian_3d(nx, ny, nz)
    n = L.shape[0]
    # block structure: couple the 3 displacement components at each vertex and
    # cross-couple neighbours with a rank-deficient-ish off-diagonal block.
    C = np.array([[2.0, 0.4, 0.2], [0.4, 2.0, 0.4], [0.2, 0.4, 2.0]])
    A = sp.kron(L, C, format="csc")
    A = A + 1e-3 * sp.eye(3 * n)
    return _sym_csc(A)


def kkt_like(nx: int, ny: int | None = None, *, reg: float = 1e-2, seed: int = 0) -> sp.csc_matrix:
    """Regularized KKT-like SPD system  [H + J^T J / reg]-style normal equations
    flavoured matrix (mimics nlpkkt80/120's wide, irregular supernodes).

    The constraint Jacobian couples *locally* (each constraint touches a
    small neighbourhood plus a medium-range state), like the PDE-constrained
    optimization nlpkkt* comes from — uniformly random couplings would
    destroy separator structure and produce a near-dense factor no ordering
    can help (not the paper's regime)."""
    ny = ny or nx
    H = laplacian_2d(nx, ny, stencil=9)
    n = H.shape[0]
    rng = np.random.default_rng(seed)
    m = n // 2
    base = rng.integers(0, n, size=m)
    rows = np.repeat(np.arange(m), 3)
    cols = np.concatenate([
        base, (base + 1) % n, (base + nx + rng.integers(0, 3, size=m)) % n
    ]).reshape(3, m).T.reshape(-1)
    vals = rng.standard_normal(3 * m)
    J = sp.csr_matrix((vals, (rows, cols)), shape=(m, n))
    A = H + (J.T @ J) / max(reg, 1e-8) * 1e-3 + sp.eye(n) * 0.5
    return _sym_csc(A)


def kkt_saddle(nx: int, *, ncon: int | None = None, scale: float = 1.0,
               seed: int = 0) -> sp.csc_matrix:
    """TRUE (unregularized) saddle-point KKT system

        [ H   B^T ]
        [ B   0   ]

    with H the SPD 9-point Laplacian on an nx^2 grid and B a local
    constraint Jacobian.  Genuinely INDEFINITE: the trailing block carries
    negative eigenvalues, so plain Cholesky breaks down — this is the
    breakdown-suite workhorse (guard='raise' identifies the first broken
    supernode, guard='perturb' factors it with recorded pivot boosts).
    ``ncon`` controls the constraint count (default nx, kept modest so the
    perturbation stays low-rank and refinement converges fast); ``scale``
    sets the magnitude of B."""
    H = laplacian_2d(nx, stencil=9)
    n = H.shape[0]
    m = ncon if ncon is not None else nx
    rng = np.random.default_rng(seed)
    base = rng.choice(n, size=m, replace=False)
    rows = np.repeat(np.arange(m), 2)
    cols = np.stack([base, (base + 1) % n], axis=1).reshape(-1)
    vals = scale * (1.0 + rng.random(2 * m))
    B = sp.csr_matrix((vals, (rows, cols)), shape=(m, n))
    # explicit (structurally stored) zero diagonal on the constraint block:
    # keeps the full diagonal in the pattern (shift retries share the plan)
    Z = sp.csr_matrix((np.zeros(m), (np.arange(m), np.arange(m))),
                      shape=(m, m))
    K = sp.bmat([[H, B.T], [B, Z]], format="csc")
    K.sort_indices()
    return K


def neumann_laplacian(nx: int, ny: int | None = None) -> sp.csc_matrix:
    """Pure-Neumann graph Laplacian (degree minus adjacency) on an nx-by-ny
    grid: symmetric positive SEMI-definite with a one-dimensional null space
    (the constant vector).  Exact Cholesky breaks down at the last pivot;
    guard='perturb' boosts it and refinement projects solves back."""
    ny = ny or nx
    ex, ey = np.ones(nx), np.ones(ny)
    Ax = sp.diags([ex[:-1], ex[:-1]], [-1, 1])
    Ay = sp.diags([ey[:-1], ey[:-1]], [-1, 1])
    Adj = sp.kron(sp.eye(ny), Ax) + sp.kron(Ay, sp.eye(nx))
    deg = np.asarray(Adj.sum(axis=1)).ravel()
    L = sp.diags(deg) - Adj
    L = sp.csc_matrix(L)
    L.sort_indices()
    return L


def gram_matrix(n: int, *, rank: int | None = None, seed: int = 0) -> sp.csc_matrix:
    """Rank-deficient Gram matrix G = X^T X with X (rank x n), rank < n:
    dense-ish PSD with an (n - rank)-dimensional null space.  Small n only —
    exercises multi-pivot perturbation recovery."""
    rng = np.random.default_rng(seed)
    r = rank if rank is not None else max(1, int(0.9 * n))
    X = rng.standard_normal((r, n))
    G = sp.csc_matrix(X.T @ X)
    G.sort_indices()
    return G


def badscale(nx: int, *, span: float = 1e6) -> sp.csc_matrix:
    """SPD but violently scaled: the 2-D Laplacian conjugated by a diagonal
    whose entries sweep ``span`` orders of magnitude.  Factors cleanly —
    a guard='raise' detection pass must NOT flag it (no false positives
    from the relative perturbation threshold)."""
    A = laplacian_2d(nx)
    n = A.shape[0]
    d = np.power(span, np.linspace(-0.5, 0.5, n))
    D = sp.diags(d)
    B = sp.csc_matrix(D @ A @ D)
    B.sort_indices()
    return _sym_csc(B)


def random_spd(n: int, *, density: float = 0.01, seed: int = 0) -> sp.csc_matrix:
    """Random sparse SPD matrix: symmetric pattern + diagonal dominance."""
    rng = np.random.default_rng(seed)
    nnz = max(int(density * n * n), n)
    rows = rng.integers(0, n, size=nnz)
    cols = rng.integers(0, n, size=nnz)
    vals = rng.standard_normal(nnz) * 0.1
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    A = (A + A.T) * 0.5
    d = np.abs(A).sum(axis=1)
    A = A + sp.diags(np.asarray(d).ravel() + 1.0)
    return _sym_csc(A)


# ---------------------------------------------------------------------------
# Benchmark suite: one entry per paper matrix *family*, scaled to CPU budget.
# name -> (constructor, kwargs, family)
# ---------------------------------------------------------------------------
MATRIX_SUITE = {
    # scalar PDE (CurlCurl_*/dielFilter* family)
    "lap2d_256": (laplacian_2d, {"nx": 256}, "2d-pde"),
    "lap2d_384": (laplacian_2d, {"nx": 384}, "2d-pde"),
    "lap2d_512": (laplacian_2d, {"nx": 512}, "2d-pde"),
    "lap2d9_256": (laplacian_2d, {"nx": 256, "stencil": 9}, "2d-pde"),
    "lap3d_24": (laplacian_3d, {"nx": 24}, "3d-pde"),
    "lap3d_32": (laplacian_3d, {"nx": 32}, "3d-pde"),
    "lap3d_40": (laplacian_3d, {"nx": 40}, "3d-pde"),
    "lap3d27_24": (laplacian_3d, {"nx": 24, "stencil": 27}, "3d-pde"),
    # structural mechanics (audikw/Fault/Emilia family: 3 dof/vertex)
    "elast3d_12": (elasticity_3d, {"nx": 12}, "elasticity"),
    "elast3d_16": (elasticity_3d, {"nx": 16}, "elasticity"),
    "elast3d_20": (elasticity_3d, {"nx": 20}, "elasticity"),
    # KKT (nlpkkt family)
    "kkt_192": (kkt_like, {"nx": 192}, "kkt"),
    "kkt_256": (kkt_like, {"nx": 256}, "kkt"),
}


# ---------------------------------------------------------------------------
# Breakdown suite: matrices plain Cholesky CANNOT factor (indefinite,
# singular, rank-deficient) plus a hostile-but-SPD control.  Kept separate
# from MATRIX_SUITE — the unguarded benchmarks factor every MATRIX_SUITE
# entry with host cholesky, which (correctly) raises on these.
# ---------------------------------------------------------------------------
BREAKDOWN_SUITE = {
    # indefinite saddle KKT: guard='raise' must identify supernode 0-level
    # breakdown, guard='perturb' must factor + refine
    "kkt_saddle_64": (kkt_saddle, {"nx": 64}, "indefinite-kkt"),
    # singular PSD (1-dim null space): one pivot hits exact zero
    "neumann_64": (neumann_laplacian, {"nx": 64}, "singular-psd"),
    # rank-deficient PSD: many dependent pivots
    "gram_400": (gram_matrix, {"n": 400}, "rank-deficient"),
    # hostile scaling control: SPD, must factor CLEAN under guard='raise'
    "badscale_64": (badscale, {"nx": 64}, "spd-badscale"),
}


def make_suite_matrix(name: str) -> sp.csc_matrix:
    if name in MATRIX_SUITE:
        fn, kwargs, _family = MATRIX_SUITE[name]
    else:
        fn, kwargs, _family = BREAKDOWN_SUITE[name]
    return fn(**kwargs)

"""Partition-refinement reordering of columns within supernodes
(Jacquelin–Ng–Peyton [11], Karsavuran–Ng–Peyton [12]).

RLB issues one DSYRK/DGEMM per block pair, so its performance is governed by
the number of blocks.  Reordering the columns *within* each supernode never
changes the fill, but it can make the update footprints of descendant
supernodes contiguous, collapsing many small blocks into few large ones.

For each supernode ``a`` we collect the restriction sets
``R_d = tail(d) ∩ cols(a)`` of every descendant ``d`` that updates ``a`` and
run ordered partition refinement: cells are split by each ``R_d`` with the
touched part placed toward the previously-touched region, which drives each
``R_d`` toward a contiguous column range.

``refine_solve`` (numpy, verbatim from the reference) refines solves
against a perturbed or shifted factor back to the original system: one
guarded iterative-refinement step, then restarted right-preconditioned
GMRES with the factor's solve as the preconditioner.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.symbolic import SymbolicFactor


def refine_cell_order(width: int, restrictions: list[np.ndarray]) -> np.ndarray:
    """Ordered partition refinement on ``range(width)``.

    restrictions: list of int arrays (column offsets in [0, width)).
    Returns a permutation ``g`` of range(width): new position k holds old
    column ``g[k]``.
    """
    if width == 1 or not restrictions:
        return np.arange(width, dtype=np.int64)
    cells: list[np.ndarray] = [np.arange(width, dtype=np.int64)]
    # bigger restriction sets first: they establish the coarse layout
    for R in sorted(restrictions, key=lambda r: -r.shape[0]):
        if R.shape[0] in (0, width):
            continue
        inR = np.zeros(width, dtype=bool)
        inR[R] = True
        new_cells: list[np.ndarray] = []
        seen_touched = False
        for C in cells:
            m = inR[C]
            hit = C[m]
            miss = C[~m]
            if hit.size == 0 or miss.size == 0:
                new_cells.append(C)
                if hit.size:
                    seen_touched = True
                continue
            if not seen_touched:
                # first touched cell: put hits last so they abut the next one
                new_cells.append(miss)
                new_cells.append(hit)
                seen_touched = True
            else:
                new_cells.append(hit)
                new_cells.append(miss)
        cells = new_cells
    return np.concatenate(cells)


def collect_restrictions(sym: SymbolicFactor) -> list[list[np.ndarray]]:
    """restrictions[a] = list of col-offset arrays from descendants updating a."""
    out: list[list[np.ndarray]] = [[] for _ in range(sym.nsuper)]
    for s in range(sym.nsuper):
        w = sym.width(s)
        t = sym.rows[s][w:]
        m = t.shape[0]
        k = 0
        while k < m:
            a = int(sym.snode[t[k]])
            fa, la = int(sym.super_ptr[a]), int(sym.super_ptr[a + 1])
            k1 = int(np.searchsorted(t, la))
            out[a].append((t[k:k1] - fa).astype(np.int64))
            k = k1
    return out


def refine_partition(sym: SymbolicFactor) -> tuple[SymbolicFactor, np.ndarray]:
    """Compute the within-supernode reordering and apply it to the symbolic
    factor.  Returns (new_sym, g) where g is the global permutation to apply
    to the already-permuted matrix: ``A2 = A[g][:, g]``."""
    n = sym.n
    restrictions = collect_restrictions(sym)
    g = np.arange(n, dtype=np.int64)
    for a in range(sym.nsuper):
        fa, la = int(sym.super_ptr[a]), int(sym.super_ptr[a + 1])
        w = la - fa
        if w > 1 and restrictions[a]:
            local = refine_cell_order(w, restrictions[a])
            g[fa:la] = fa + local

    # relabel: old label r -> new label gmap[r]
    gmap = np.empty(n, dtype=np.int64)
    gmap[g] = np.arange(n, dtype=np.int64)

    rows = []
    for s in range(sym.nsuper):
        w = sym.width(s)
        tail = np.sort(gmap[sym.rows[s][w:]])
        rows.append(np.concatenate([sym.rows[s][:w], tail]))

    # rebuild the column etree consistent with the relabeling
    parent = np.full(n, -1, dtype=np.int64)
    for s in range(sym.nsuper):
        f, l = int(sym.super_ptr[s]), int(sym.super_ptr[s + 1])
        parent[f:l - 1] = np.arange(f + 1, l, dtype=np.int64)
        t = rows[s][l - f:]
        parent[l - 1] = t[0] if t.shape[0] else -1

    new_sym = SymbolicFactor(
        n=n, perm=sym.perm[g], parent=parent, super_ptr=sym.super_ptr.copy(),
        rows=rows, snode=sym.snode.copy(), sparent=sym.sparent.copy(),
        colcount=None,
    )
    return new_sym, g


# ---------------------------------------------------------------------------
# residual-driven solve refinement (breakdown recovery)
# ---------------------------------------------------------------------------
def refine_solve(F, A, b, *, x0=None, tol=1e-12, max_iter=None,
                 backend: str = "host", engine=None):
    """Refine ``F.solve`` toward the solution of the ORIGINAL system A x = b.

    Used after ``guard="perturb"`` / ``guard="shift"`` recovery: the factor
    ``F`` is an exact factorization of a *perturbed* matrix A + E, so its raw
    solve is only a preconditioner for A.  One cheap iterative-refinement
    step is taken first (it alone converges when A is SPD and E is small),
    then right-preconditioned full-basis GMRES with ``M^{-1} = F.solve``
    finishes the job: stationary IR provably stalls when A is indefinite —
    a pivot perturbed from d <= 0 up to t > 0 contributes an iteration factor
    |t - d| / t >= 1 — while GMRES with a rank-p perturbation preconditioner
    terminates in at most p + 1 iterations.

    Returns ``(x, hist)`` where ``hist`` is the relative-residual trajectory
    (max over RHS columns for multi-RHS ``b``).
    """
    b = np.asarray(b, dtype=np.float64)
    squeeze = b.ndim == 1
    B = b[:, None] if squeeze else b
    if max_iter is None:
        # full-basis GMRES terminates exactly within n steps; rank-p
        # perturbations (guard='perturb') need only p + 1 — budget 2p plus
        # slack for finite-precision drag — while full-rank shifts
        # (guard='shift') may need the spectrum-driven worst case
        rep = getattr(F, "guard_report", None)
        p = sum(q["n_clamped"] for q in rep.perturbations) if rep else 0
        if rep is not None and p and not rep.shift:
            max_iter = int(min(B.shape[0], max(2 * p + 30, 100)))
        else:
            max_iter = int(min(B.shape[0], 300))

    def psolve(v):
        return np.asarray(
            F.solve(v, backend=backend, engine=engine, refine=False)
        )

    cols, hists = [], []
    for j in range(B.shape[1]):
        xj, hj = _refine_one(A, B[:, j],
                             None if x0 is None else np.asarray(x0)[..., j],
                             psolve, tol, max_iter)
        cols.append(xj)
        hists.append(hj)
    x = np.stack(cols, axis=-1)
    # combine per-column trajectories: entry i = worst column at stage i
    depth = max(len(h) for h in hists)
    hist = [max(h[min(i, len(h) - 1)] for h in hists) for i in range(depth)]
    return (x[:, 0] if squeeze else x), hist


def _refine_one(A, b, x0, psolve, tol, max_iter):
    """Single-RHS refinement: 1 guarded IR step, then restarted
    right-preconditioned GMRES cycles."""
    bnorm = float(np.linalg.norm(b))
    if bnorm == 0.0:
        return np.zeros_like(b), [0.0]
    x = psolve(b) if x0 is None else x0.astype(np.float64).copy()
    r = b - A @ x
    hist = [float(np.linalg.norm(r)) / bnorm]
    if hist[-1] <= tol:
        return x, hist
    # one stationary IR step — free when E is tiny relative to an SPD A, but
    # DIVERGENT when A is indefinite (iteration factor |t - d|/t >= 1 for a
    # flipped pivot), so accept it only if it actually reduced the residual:
    # GMRES can only recover ~machine precision RELATIVE to its starting
    # residual, so letting IR blow r up by 1e5 costs 1e5 in final accuracy
    xt = x + psolve(r)
    rt = b - A @ xt
    if float(np.linalg.norm(rt)) < float(np.linalg.norm(r)):
        x, r = xt, rt
    hist.append(float(np.linalg.norm(r)) / bnorm)
    if hist[-1] <= tol:
        return x, hist
    # restarted right-preconditioned GMRES on the residual equation: each
    # cycle's attainable accuracy is ~eps * kappa relative to ITS OWN r0, so
    # restarting from the corrected iterate compounds the reduction past the
    # single-cycle floating-point floor
    for _cycle in range(4):
        beta = float(np.linalg.norm(r))
        V = [r / beta]
        H = np.zeros((max_iter + 1, max_iter))
        e1 = np.zeros(max_iter + 1)
        e1[0] = beta
        y, niter = None, 0
        for j in range(max_iter):
            w = A @ psolve(V[j])
            for i in range(j + 1):
                H[i, j] = float(V[i] @ w)
                w = w - H[i, j] * V[i]
            # one reorthogonalization pass: single-pass MGS loses
            # orthogonality over ~100 iterations and breaks the
            # exact-termination property the rank-p argument relies on
            for i in range(j + 1):
                c = float(V[i] @ w)
                H[i, j] += c
                w = w - c * V[i]
            H[j + 1, j] = float(np.linalg.norm(w))
            niter = j + 1
            y = np.linalg.lstsq(H[:j + 2, :j + 1], e1[:j + 2], rcond=None)[0]
            res = float(np.linalg.norm(e1[:j + 2] - H[:j + 2, :j + 1] @ y))
            hist.append(res / bnorm)
            if res <= tol * bnorm or H[j + 1, j] <= 1e-300:
                break
            V.append(w / H[j + 1, j])
        if y is None:
            break
        prev = float(np.linalg.norm(r))
        z = np.stack(V[:niter], axis=1) @ y
        x = x + psolve(z)
        r = b - A @ x
        hist[-1] = float(np.linalg.norm(r)) / bnorm  # true, not Arnoldi, resid
        if hist[-1] <= tol or not float(np.linalg.norm(r)) < 0.5 * prev:
            break
    return x, hist

"""The guarded fused kernel's route, replayed in numpy on the CPU.

``csrc/fused_factor_syrk.cu`` factors each 64-column slab of a guarded call
speculatively on the unguarded route (the blocked factor in 8-wide
sub-blocks with rsqrt pivots, ``X = A21 L11^-T`` below), keeps each pivot
``x`` before its rsqrt and, per column, the largest ``|L[r][k]|`` below the
diagonal, then checks every lane: a lane passes when each real column's
``x`` and ``theta = sqrt(x) max |L[r][k]|`` are finite, ``x > 0`` and ``x``
clears ``thr`` and the growth floor ``theta^2 GFLOOR_MULT / thr`` by a
relative margin of 1e-8 plus an absolute slack of ``4 * 64 * eps (|pre| +
|x|)`` (``pre`` the column's diagonal before the slab); any other lane
restores its slab and sweeps it column by column as the reference does.  A
CUDA kernel cannot run here, so these tests replay that scheme in numpy,
slab by slab, and hold it to the plain version
``fused_factor_syrk_guarded_ref`` (the reference's clamping chain): the
factor within 1e-12 relative, clamp counts and flags equal, ``min d^2`` and
the clamp magnitude within rtol 1e-10.  The replay also runs whole
factorizations through the port's CPU engine in place of the guarded
kernel, held to the reference's xla route (``pytest.importorskip("jax")``).
"""
import math

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import repro_torch.core.engines as engines
from repro_torch.core import BreakdownError, cholesky, perturb_threshold
from repro_torch.core.guard import GFLOOR_MULT
from repro_torch.kernels import fused_factor_syrk, live_cells
from repro_torch.kernels.fused import (
    _mask,
    fused_factor_syrk_guarded,
    fused_factor_syrk_guarded_ref,
    guarded_sweeps,
)
from repro_torch.sparse import laplacian_3d
from repro_torch.sparse.gen import kkt_saddle, neumann_laplacian

NB = 64         # slab width
SB = 8          # sub-block width of the diagonal factor
DT = 64         # row tile of the panel launch
DELTA = 1e-8    # the check's relative margin
SLACK = 4.0 * NB * float(np.finfo(np.float64).eps)


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


def _blocked_factor(A11):
    """The panel launch's unclamped blocked factor of a 64 x 64 diagonal
    block (lower triangle; identity past the slab): 8 x 8 sub-blocks
    factored with rsqrt pivots, the rows below by the sub-block's inverse,
    then the trailing lower triangle.  Returns (L11, pivots)."""
    S = np.tril(A11)
    piv = np.empty(NB)
    i = np.arange(SB)
    with np.errstate(all="ignore"):
        for J in range(NB // SB):
            j0 = J * SB
            a = S[j0:j0 + SB, j0:j0 + SB].copy()
            for q in range(SB):
                x = a[q, q]
                piv[j0 + q] = x
                rq = 1.0 / np.sqrt(x)          # rsqrt: inf at 0, NaN below
                a[:, q] = np.where(i == q, x * rq,
                                   np.where(i > q, a[:, q] * rq, 0.0))
                for p in range(q + 1, SB):
                    a[i >= p, p] -= a[i >= p, q] * a[p, q]
            S[j0:j0 + SB, j0:j0 + SB] = a
            if j0 + SB == NB:
                break
            D = sla.solve_triangular(a, np.eye(SB), lower=True,
                                     check_finite=False)
            lo = j0 + SB
            S[lo:, j0:lo] = S[lo:, j0:lo] @ D.T
            S[lo:, lo:] -= np.tril(S[lo:, j0:lo] @ S[lo:, j0:lo].T)
    return np.tril(S), piv


def _tile_live(r0, r1, w, m, Wp):
    return r0 < w or (r0 < Wp + m and r1 > Wp)


def _nan_max(x, y):
    """max that propagates NaN, as jnp.maximum and the kernel's nan_max."""
    return x if x != x else (y if y != y else max(x, y))


def _sweep(a, k0, k1, w, m, Wp, thr, stat):
    """The column sweep of the real columns [k0, k1) over the live rows
    (the routed lanes' path), updating stat = [mind2, ncl, bad, mag]."""
    tmax = max(thr, 1e-300)
    with np.errstate(all="ignore"):
        for k in range(k0, k1):
            live = np.r_[np.arange(k + 1, w), np.arange(Wp, Wp + m)]
            col = a[live, k]
            theta = np.max(np.abs(col)) if col.size else 0.0   # NaN wins
            d2 = a[k, k]
            if d2 < stat[0]:
                stat[0] = d2
            gfloor = theta * theta * (GFLOOR_MULT / tmax)
            if thr > 0 and (not d2 >= thr or not d2 >= gfloor):
                d2c = _nan_max(_nan_max(thr, abs(d2)), gfloor)
                d2c = d2c if np.isfinite(d2c) else thr
                stat[1] += 1
                stat[3] += d2c - d2 if np.isfinite(d2) else d2c
                d2 = d2c
            dk = math.sqrt(d2) if d2 >= 0 else float("nan")
            a[k, k] = dk
            v = col / dk
            a[live, k] = v
            stat[2] = stat[2] or not (np.isfinite(dk) and np.isfinite(v).all())
            for jj, j in enumerate(range(k + 1, k1)):
                rs = live[live >= j]
                a[rs, j] -= a[rs, k] * v[jj]


def replay_guarded(panels, rows, ws, thr):
    """The card's guarded route in numpy.  Returns (fp, u, st) as the
    wrapper does, and swept (nslab, Bp): the pairs the check routed."""
    Bp, Lp, Wp = panels.shape
    thr = float(thr)
    a = _mask(torch.as_tensor(panels), torch.as_tensor(rows),
              torch.as_tensor(ws)).numpy().copy()
    st = np.tile([np.inf, 0.0, 0.0, 0.0], (Bp, 1))
    nb = min(Wp, NB)
    nslab = -(-Wp // nb)
    swept = np.zeros((nslab, Bp), bool)
    for s in range(nslab):
        k0 = s * nb
        nbk = min(nb, Wp - k0)
        kp = k0 + nbk
        for b in range(Bp):
            w = int(ws[b])
            if w <= k0:
                continue
            mf = int(rows[b]) - w
            k1 = min(kp, w)
            A11 = np.eye(NB)
            A11[:nbk, :nbk] = a[b, k0:kp, k0:kp]
            L11, piv = _blocked_factor(A11)
            Li = sla.solve_triangular(L11, np.eye(NB), lower=True,
                                      check_finite=False)
            tiles = [(r0, min(r0 + DT, Lp)) for r0 in range(kp, Lp, DT)
                     if _tile_live(r0, min(r0 + DT, Lp), w, mf, Wp)]
            X = {r0: a[b, r0:r1, k0:kp] @ Li[:nbk, :nbk].T
                 for r0, r1 in tiles}
            with np.errstate(all="ignore"):
                ok = True
                for c in range(k1 - k0):
                    below = [np.abs(L11[c + 1:nbk, c])] + [
                        np.abs(t[:, c]) for t in X.values()]
                    mx = np.max(np.concatenate(below + [[0.0]]))
                    x = piv[c]
                    theta = math.sqrt(x) * mx if x >= 0 else float("nan")
                    pre = a[b, k0 + c, k0 + c]
                    slack = SLACK * (abs(pre) + abs(x))
                    good = (np.isfinite(x) and np.isfinite(theta) and x > 0
                            and x >= thr * (1 + DELTA) + slack)
                    if thr > 0:
                        good = good and x >= (theta * theta * (GFLOOR_MULT
                                              / thr) * (1 + DELTA) + slack)
                    ok = ok and good
            if ok:  # the speculative slab stands
                a[b, k0:kp, k0:kp] = L11[:nbk, :nbk]
                for r0, r1 in tiles:
                    a[b, r0:r1, k0:kp] = X[r0]
                st[b, 0] = min([st[b, 0]] + list(piv[:k1 - k0]))
            else:
                swept[s, b] = True
                m = min(mf, Lp - Wp)
                _sweep(a[b], k0, k1, w, m, Wp, thr, st[b])
            if w > kp:  # the trailing launch: real columns right of it
                S = a[b, :, k0:kp]
                with np.errstate(all="ignore"):
                    upd = S[kp:] @ S[kp:Wp].T
                r = np.arange(kp, Lp)[:, None]
                c = np.arange(kp, Wp)[None, :]
                a[b, kp:, kp:Wp] -= np.where(r >= c, upd, 0.0)
    mp = Lp - Wp
    u = np.zeros((Bp, mp, mp))
    for b in range(Bp):
        m = min(int(rows[b]) - int(ws[b]), mp)
        T = a[b, Wp:Wp + m, :]
        with np.errstate(all="ignore"):
            u[b, :m, :m] = np.tril(T @ T.T)
    return a, u, st, swept


def _hold(panels, rows, ws, thr):
    """Replay against the plain version; returns the replay's swept map."""
    fp, u, st, swept = replay_guarded(panels, rows, ws, thr)
    fr, ur, sr = (t.numpy() for t in fused_factor_syrk_guarded_ref(
        torch.from_numpy(panels), torch.from_numpy(rows),
        torch.from_numpy(ws), thr))
    np.testing.assert_array_equal(st[:, 1:3], sr[:, 1:3])   # counts, flags
    np.testing.assert_allclose(st[:, [0, 3]], sr[:, [0, 3]], rtol=1e-10,
                               atol=0)
    Bp, Lp, Wp = panels.shape
    live = live_cells(torch.from_numpy(rows), torch.from_numpy(ws), Lp, Wp,
                      "cpu").numpy()
    fin = np.isfinite(fr[live])
    np.testing.assert_array_equal(np.isfinite(fp[live]), fin)
    scale = np.max(np.abs(fr[live][fin]))
    np.testing.assert_allclose(fp[live][fin], fr[live][fin], rtol=0,
                               atol=1e-12 * scale)
    ok = sr[:, 2] == 0      # a clean lane: every cell, and its update
    np.testing.assert_allclose(fp[ok], fr[ok], rtol=0, atol=1e-12 * scale)
    if Lp > Wp and ok.any():
        np.testing.assert_allclose(u[ok], ur[ok], rtol=0,
                                   atol=1e-12 * np.max(np.abs(ur[ok])))
    return swept


def _spd_group(extents, Lp, Wp, seed):
    """SPD diagonal blocks, random tails, garbage in every pad cell."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((len(extents), Lp, Wp))
    for i, (r, w) in enumerate(extents):
        if w:
            G = rng.standard_normal((w, w))
            lo = np.tril_indices(w)
            p[i, :w, :w][lo] = (G @ G.T / w + 2 * np.eye(w))[lo]
            p[i, Wp:Wp + r - w, :w] = 0.5 * rng.standard_normal((r - w, w))
    rows = np.array([r for r, _ in extents], np.int32)
    ws = np.array([w for _, w in extents], np.int32)
    return p, rows, ws


SPD_CASES = [
    ([(20, 8), (16, 16), (9, 1), (0, 0)], 32, 16),              # one slab
    ([(300, 100), (150, 64), (101, 99), (0, 0)], 336, 128),     # two
    ([(400, 190), (300, 130), (64, 64)], 448, 192),             # three
]


@pytest.mark.parametrize("thr", [0.0, 5e-12, 0.25])
@pytest.mark.parametrize("case", range(len(SPD_CASES)))
def test_replay_matches_plain_on_spd_lanes(case, thr):
    p, rows, ws = _spd_group(*SPD_CASES[case], seed=case)
    swept = _hold(p, rows, ws, thr)
    assert not swept.any()      # every slab took the speculative route


@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_near_threshold_pivot_in_second_slab_is_routed(sign):
    # lane 0's column 70 is decoupled (zero row and column off the
    # diagonal), so its pivot is its diagonal exactly: thr (1 -/+ 1e-10),
    # which the sweep clamps (-) or keeps (+); the margin routes both
    thr = 5.46e-12
    p, rows, ws = _spd_group([(260, 150), (200, 120)], 288, 160, seed=7)
    k = 70
    p[0, k, :k] = 0.0
    p[0, k + 1:150, k] = 0.0
    p[0, 160:, k] = 0.0
    p[0, k, k] = thr * (1.0 + sign * 1e-10)
    swept = _hold(p, rows, ws, thr)
    assert swept.tolist() == [[False, False], [True, False], [False, False]]
    st = replay_guarded(p, rows, ws, thr)[2]
    assert st[0, 1] == (1.0 if sign < 0 else 0.0)


def test_nan_lane_is_routed_from_its_slab_on():
    thr = 1e-3
    p, rows, ws = _spd_group([(260, 150), (200, 120)], 288, 160, seed=8)
    p[0, 160 + 3, 70] = np.nan        # a tail cell in slab 2's column
    for t in (0.0, thr):
        swept = _hold(p, rows, ws, t)
        assert not swept[0].any() and swept[1, 0] and not swept[:, 1].any()


def _captured_groups(A, guard):
    """The guarded kernel's inputs of one CPU factorization of A."""
    seen = []
    real = engines.fused_factor_syrk

    def record(buf, rows, ws, **kw):
        if kw.get("guard"):
            seen.append((buf.numpy().copy(), rows.numpy().copy(),
                         ws.numpy().copy(), kw.get("thr", 0.0)))
        return real(buf, rows, ws, **kw)

    engines.fused_factor_syrk = record
    try:
        cholesky(A, device="cpu", guard=guard)
    except BreakdownError:
        pass
    finally:
        engines.fused_factor_syrk = real
    return seen


def test_replay_matches_plain_on_kkt_saddle_groups():
    K = kkt_saddle(8)
    thr = perturb_threshold(float(np.max(np.abs(K.diagonal()))))
    groups = _captured_groups(K, "perturb")
    assert groups
    routed = 0
    for p, rows, ws, t in groups:
        assert t == thr
        routed += int(_hold(p, rows, ws, t).sum())
        _hold(p, rows, ws, 0.0)
    assert routed > 0           # the clamping lanes took the sweep


def _through_replay(fn):
    """Run fn with the port's CPU engine calling the replay for every
    guarded kernel call."""
    real = engines.fused_factor_syrk

    def replayed(buf, rows, ws, *, guard=False, thr=0.0):
        if not guard:
            return real(buf, rows, ws)
        fp, u, st, _ = replay_guarded(buf.numpy(), rows.numpy(), ws.numpy(),
                                      thr)
        return tuple(torch.from_numpy(np.ascontiguousarray(x))
                     for x in (fp, u, st))

    engines.fused_factor_syrk = replayed
    try:
        return fn()
    finally:
        engines.fused_factor_syrk = real


def test_replayed_raise_and_perturb_match_reference():
    # the thr = 0 status (pivots before rsqrt, the flags) decides the
    # broken-supernode list; thr > 0 the clamps, both against the xla route
    pytest.importorskip("jax")
    import repro.core as ref
    from repro.sparse.gen import kkt_saddle as ref_kkt

    K = kkt_saddle(8)
    assert (K != ref_kkt(8)).nnz == 0
    xla = ref.DeviceEngine(backend="xla")
    with pytest.raises(BreakdownError) as ep:
        _through_replay(lambda: cholesky(K, device="cpu", guard="raise"))
    with pytest.raises(ref.BreakdownError) as er:
        ref.cholesky(K, device_engine=xla, guard="raise")
    assert ep.value.report.first_broken == er.value.report.first_broken
    assert [q["supernode"] for q in ep.value.report.broken] == \
        [q["supernode"] for q in er.value.report.broken]
    F = _through_replay(lambda: cholesky(K, device="cpu", guard="perturb"))
    R = ref.cholesky(K, device_engine=xla, guard="perturb")

    def clamps(rep):
        return [(q["supernode"], q["n_clamped"]) for q in rep.perturbations]

    assert clamps(F.guard_report) == clamps(R.guard_report)
    assert F.guard_report.n_perturbed > 0
    b = np.ones(K.shape[0])
    x = F.solve(b)
    assert np.linalg.norm(K @ x - b) <= 1e-10 * np.linalg.norm(b)


@pytest.mark.parametrize("make,guard", [(lambda: laplacian_3d(6), "raise"),
                                        (lambda: neumann_laplacian(10),
                                         "perturb")])
def test_replayed_factor_matches_plain_route(make, guard):
    # a whole factorization through the replay equals the plain version's
    A = make()
    F = _through_replay(lambda: cholesky(A, device="cpu", guard=guard))
    G = cholesky(A, device="cpu", guard=guard, sym=F.sym)
    scale = np.abs(G.store.storage).max()
    assert np.abs(F.store.storage - G.store.storage).max() <= 1e-12 * scale
    rf, rg = F.guard_report, G.guard_report
    assert rf.ok and rg.ok
    assert [(q["supernode"], q["n_clamped"]) for q in rf.perturbations] == \
        [(q["supernode"], q["n_clamped"]) for q in rg.perturbations]


def test_empty_group_and_sweep_record_on_the_cpu():
    # no lanes: the plain version's empty outputs on either route; the
    # sweep record belongs to card calls only
    p = torch.zeros((0, 24, 8), dtype=torch.float64)
    r = torch.zeros(0, dtype=torch.int32)
    fp, u, st = fused_factor_syrk_guarded(p, r, r, 1e-3)
    assert (fp.shape, u.shape, st.shape) == ((0, 24, 8), (0, 16, 16), (0, 4))
    fp, u = fused_factor_syrk(p, r, r)
    assert (fp.shape, u.shape) == ((0, 24, 8), (0, 16, 16))
    assert guarded_sweeps() == 0

"""The breakdown guard of the port on the CPU against the reference.

The guarded kernel's plain version (``fused_factor_syrk_guarded_ref``) is
held against the reference's Pallas kernel in interpret mode on tiny
groups; the guarded paths (``cholesky(guard=...)``, ``cholesky_many(guard=
...)``) are held against the reference's xla route on every scenario of
``tests/test_guard.py``.  Clamp decisions are expected to agree exactly:
the plans are bit-identical and the plain version mirrors the xla chain
operation for operation.  Also here: the repair that makes a failed
factorization come out NaN instead of raising (the reference's behaviour).
"""
import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

pytest.importorskip("jax")

import repro.core as ref  # noqa: E402
from repro.kernels.fused import fused_factor_syrk as pallas_fused  # noqa: E402
from repro.sparse.gen import (  # noqa: E402
    badscale,
    gram_matrix,
    kkt_saddle,
    laplacian_2d,
    neumann_laplacian,
)

from repro_torch.core import (  # noqa: E402
    BadMatrixError,
    BreakdownError,
    DeviceEngine,
    HostEngine,
    cholesky,
    cholesky_many,
)
from repro_torch.kernels import fused_factor_syrk  # noqa: E402

RESID = 1e-10


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


def _resid(A, x, b):
    return float(np.linalg.norm(A @ x - b) / np.linalg.norm(b))


_XLA = []


def _xla():
    """One reference xla engine for the module: its compiled programs are
    shared by every test here (only its stats accumulate)."""
    if not _XLA:
        _XLA.append(ref.DeviceEngine(backend="xla"))
    return _XLA[0]


def _cpu(**kw):
    return DeviceEngine(device="cpu", **kw)


# ---------------------------------------------------------------------------
# the guarded kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------
def _guard_group(seed):
    """Lanes (rows, w) of a (5, 24, 8) group, garbage in every pad cell:
    SPD, indefinite (a negative pivot), a zero pivot under large
    off-diagonals (the growth floor fires when thr > 0), a ragged tail and
    a pad lane."""
    rng = np.random.default_rng(seed)
    Bp, Lp, Wp = 5, 24, 8
    p = rng.standard_normal((Bp, Lp, Wp))
    ext = [(20, 8), (13, 6), (16, 8), (9, 3), (0, 0)]
    for i, (r, w) in enumerate(ext[:-1]):
        G = rng.standard_normal((w, w))
        D = G @ G.T / w + 2.0 * np.eye(w)
        if i == 1:
            D[2, 2] = -3.0          # indefinite
        if i == 2:
            D[0, :] = D[:, 0] = 0.0
            D[1:, 0] = 10.0         # zero pivot, large column below it
            D[0, 0] = 0.0
        lo = np.tril_indices(w)
        p[i, :w, :w][lo] = D[lo]
        p[i, Wp:Wp + r - w, :w] = 0.5 * rng.standard_normal((r - w, w))
    rows = np.array([r for r, _ in ext], np.int32)
    ws = np.array([w for _, w in ext], np.int32)
    return p, rows, ws


@pytest.mark.parametrize("thr", [0.0, 2.0 ** -30, 0.25])
def test_guarded_ref_matches_pallas(thr):
    # every thr is a float32 value, so the Pallas route's float32 shipping
    # of thr changes nothing
    p, rows, ws = _guard_group(0)
    fr, ur, sr = (np.asarray(a) for a in pallas_fused(
        p, rows, ws, interpret=True, guard=True, thr=thr))
    fp, u, st = (t.numpy() for t in fused_factor_syrk(
        torch.from_numpy(p), torch.from_numpy(rows), torch.from_numpy(ws),
        guard=True, thr=thr))
    assert st.shape == (5, 4)
    np.testing.assert_array_equal(st[:, 1:3], sr[:, 1:3])  # counts, flags
    np.testing.assert_allclose(st[:, [0, 3]], sr[:, [0, 3]], rtol=1e-12,
                               atol=0)
    assert st[4].tolist() == [np.inf, 0.0, 0.0, 0.0]      # pad lane
    if thr > 0:
        assert st[2, 1] >= 1 and st[1, 1] >= 1             # floor, flip
        assert not st[:, 2].any()
    else:
        assert st[1, 2] == 1 and st[2, 2] == 1 and st[1, 0] < 0
    # the factor on every lane the reference left finite (the Pallas
    # kernel's full-width rank-1 product smears a broken lane's NaN into
    # finished cells, inf * 0, so a broken lane is compared by status)
    fin = [i for i in range(5) if np.isfinite(fr[i]).all()]
    assert fin == [i for i in range(5) if st[i, 2] == 0]
    sf = np.max(np.abs(fr[fin]))
    np.testing.assert_allclose(fp[fin], fr[fin], rtol=0, atol=1e-12 * sf)
    su = np.max(np.abs(ur[fin]))
    np.testing.assert_allclose(u[fin], ur[fin], rtol=0, atol=1e-11 * su)


def test_unguarded_plain_version_gives_nan_not_an_exception():
    p, rows, ws = _guard_group(1)
    fp, u = fused_factor_syrk(torch.from_numpy(p), torch.from_numpy(rows),
                              torch.from_numpy(ws))
    bad = [i for i in range(5) if not torch.isfinite(fp[i]).all()]
    assert bad == [1, 2]   # the indefinite lane and the zero pivot
    assert torch.isfinite(fp[[0, 3, 4]]).all()
    # no NaN outside a lane's true (m, m) update block
    assert torch.isfinite(u[[0, 3, 4]]).all() and (u[1, 7:, :] == 0).all()


# ---------------------------------------------------------------------------
# a failed factorization is NaN, not an exception (guard="off")
# ---------------------------------------------------------------------------
def _nan_snodes(F):
    return [s for s in range(F.sym.nsuper)
            if not np.isfinite(F.panels[s]).all()]


@pytest.mark.parametrize("kw,fused", [
    ({}, True),
    ({"schedule": "seq"}, True),
    ({"schedule": "seq"}, False),
    ({"schedule": "seq", "method": "rlb"}, True),
    ({"schedule": "seq", "method": "rlb"}, False),
])
def test_failed_factorization_is_nan_like_reference(kw, fused):
    K = kkt_saddle(8)
    Fr = ref.cholesky(K, device_engine=_xla(), **kw)
    Fp = cholesky(K, device_engine=_cpu(fused=fused), **kw)
    broken = _nan_snodes(Fp)
    assert broken and broken == _nan_snodes(Fr)


def test_host_engine_still_raises():
    K = kkt_saddle(8)
    with pytest.raises(np.linalg.LinAlgError):
        cholesky(K, device="cpu", schedule="seq", offload_threshold=10 ** 12)
    with pytest.raises(np.linalg.LinAlgError):
        HostEngine().factor((np.array([[-1.0]]), 1))


# ---------------------------------------------------------------------------
# raise
# ---------------------------------------------------------------------------
def test_raise_matches_reference():
    K = kkt_saddle(8)
    with pytest.raises(BreakdownError) as ep:
        cholesky(K, device="cpu", guard="raise")
    with pytest.raises(ref.BreakdownError) as er:
        ref.cholesky(K, device_engine=_xla(), guard="raise")
    rp, rr = ep.value.report, er.value.report
    assert rp.guard == "raise" and not rp.ok
    assert (rp.first_broken, rp.first_broken_level) == \
        (rr.first_broken, rr.first_broken_level)
    assert [(b["supernode"], b["level"]) for b in rp.broken] == \
        [(b["supernode"], b["level"]) for b in rr.broken]
    assert str(rp.first_broken) in str(ep.value)
    # the port's min pivot is the Pallas route's (the negative pivot; the
    # xla route reads NaN there), compared once against it
    with pytest.raises(ref.BreakdownError) as ea:
        ref.cholesky(K, device_engine=ref.DeviceEngine(backend="pallas"),
                     guard="raise")
    ra = ea.value.report
    assert rp.broken[0]["min_pivot"] < 0
    np.testing.assert_allclose(rp.min_pivot, ra.min_pivot, rtol=1e-12)
    np.testing.assert_allclose(
        [b["min_pivot"] for b in rp.broken],
        [b["min_pivot"] for b in ra.broken], rtol=1e-12)


@pytest.mark.parametrize("make,well_posed", [(lambda: laplacian_2d(16), True),
                                             (lambda: badscale(16), False)])
def test_raise_clean(make, well_posed):
    # badscale spans 1e12 in its pivots: no false positive, and (as in the
    # reference's test) no residual bar for so ill-conditioned a matrix
    A = make()
    F = cholesky(A, device="cpu", guard="raise")
    rep = F.guard_report
    assert rep.ok and rep.first_broken is None and not rep.perturbations
    assert rep.min_pivot > 0
    np.testing.assert_allclose(rep.min_pivot, min(
        float(np.min(np.diagonal(P) ** 2)) for P in F.panels), rtol=1e-12)
    assert F.guard_A is None
    if well_posed:
        b = np.ones(A.shape[0])
        assert _resid(A, F.solve(b, backend="device"), b) < RESID


# ---------------------------------------------------------------------------
# perturb
# ---------------------------------------------------------------------------
def _clamps(rep):
    return [(p["supernode"], p["n_clamped"]) for p in rep.perturbations]


@pytest.mark.parametrize("make,in_range", [
    (lambda: kkt_saddle(8), False),
    (lambda: neumann_laplacian(12), True),
    (lambda: gram_matrix(120, seed=2), True),
])
def test_perturb_matches_reference(make, in_range):
    A = make()
    F = cholesky(A, device="cpu", guard="perturb")
    Fr = ref.cholesky(A, device_engine=_xla(), guard="perturb")
    rep, rr = F.guard_report, Fr.guard_report
    assert rep.ok and rep.n_perturbed > 0
    assert _clamps(rep) == _clamps(rr)
    assert rep.perturb_thr == rr.perturb_thr
    # the magnitudes are not compared: a singular matrix's last pivots are
    # rounding noise of a cancelling sum, summed in another order here
    assert all(p["magnitude"] > 0 for p in rep.perturbations)
    rng = np.random.default_rng(3)
    b = (np.asarray(A @ rng.standard_normal(A.shape[0])) if in_range
         else np.arange(A.shape[0], dtype=float) % 5 + 1)
    for be in ("device", "host"):
        x = F.solve(b, backend=be)  # refined: the factor is perturbed
        assert _resid(A, x, b) <= RESID, be
    assert _resid(A, Fr.solve(b), b) <= RESID
    assert rep.ir_history and rep.ir_history[-1][-1] <= RESID


def test_perturb_report_json_roundtrip():
    F = cholesky(kkt_saddle(8), device="cpu", guard="perturb")
    d = json.loads(json.dumps(F.guard_report.to_dict()))
    assert d["guard"] == "perturb" and d["ok"]
    assert d["n_perturbed"] == F.guard_report.n_perturbed
    assert {"supernode", "level", "min_pivot", "n_clamped", "magnitude"} <= \
        set(d["perturbations"][0])


def test_perturb_off_the_device_resident_path_raises():
    with pytest.raises(ValueError, match="perturb"):
        cholesky(kkt_saddle(8), device="cpu", schedule="seq",
                 guard="perturb")


# ---------------------------------------------------------------------------
# shift
# ---------------------------------------------------------------------------
def test_shift_matches_reference():
    K = kkt_saddle(8)
    F = cholesky(K, device="cpu", guard="shift")
    Fr = ref.cholesky(K, device_engine=_xla(), guard="shift")
    rep = F.guard_report
    assert rep.ok and rep.guard == "shift" and rep.shift > 0
    assert (rep.shift, rep.shifts) == (Fr.guard_report.shift,
                                       Fr.guard_report.shifts)
    b = np.ones(K.shape[0])
    assert _resid(K, F.solve(b, backend="device"), b) <= RESID


# ---------------------------------------------------------------------------
# hostile inputs, the host path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("where,val,kind", [
    ((3, 3), np.nan, "nonfinite"),
    ((10, 10), np.inf, "nonfinite"),
    ((0, 5), 17.0, "asymmetric"),
])
@pytest.mark.parametrize("kw", [{}, {"schedule": "seq"}])
def test_hostile_inputs_rejected(where, val, kind, kw):
    A = laplacian_2d(8).tolil()
    A[where] = val
    with pytest.raises(BadMatrixError) as ei:
        cholesky(A.tocsc(), device="cpu", guard="raise", **kw)
    assert ei.value.kind == kind
    with pytest.raises(ref.BadMatrixError) as er:
        ref.cholesky(A.tocsc(), guard="raise")
    assert er.value.kind == kind


def test_host_path_guard_raise_and_clean():
    host = {"schedule": "seq", "offload_threshold": 10 ** 12}
    with pytest.raises(BreakdownError) as ei:
        cholesky(kkt_saddle(8), device="cpu", guard="raise", **host)
    assert ei.value.report.broken[0]["supernode"] is None
    A = laplacian_2d(12)
    F = cholesky(A, device="cpu", guard="raise", **host)
    Fr = ref.cholesky(A, guard="raise")
    assert F.guard_report.ok and F.guard_report.min_pivot > 0
    assert F.guard_report.min_pivot == Fr.guard_report.min_pivot


def test_seq_raise_keeps_the_references_nan_blind_report():
    # the reference's _attach_guard takes min(m, nan), which keeps m: a
    # device seq factor holding NaN comes back with an ok report
    K = kkt_saddle(8)
    F = cholesky(K, device="cpu", schedule="seq", guard="raise")
    Fr = ref.cholesky(K, device_engine=_xla(), schedule="seq", guard="raise")
    assert F.guard_report.ok and Fr.guard_report.ok
    assert F.guard_report.min_pivot == Fr.guard_report.min_pivot
    assert _nan_snodes(F) == _nan_snodes(Fr) != []


# ---------------------------------------------------------------------------
# guard="off" is the pre-guard program
# ---------------------------------------------------------------------------
def test_guard_off_is_pre_guard_program():
    A = laplacian_2d(16)
    e1, e2 = _cpu(), _cpu()
    F1 = cholesky(A, device_engine=e1)
    F2 = cholesky(A, device_engine=e2, guard="off")
    assert F2.guard_report is None
    assert e1.stats == e2.stats
    np.testing.assert_array_equal(F1.L_dense(), F2.L_dense())
    # a clean guarded run reads back in the same transfers
    e3 = _cpu()
    cholesky(A, device_engine=e3, guard="raise")
    for k in ("transfers_in", "transfers_out", "device_calls"):
        assert e3.stats[k] == e1.stats[k], k


# ---------------------------------------------------------------------------
# cholesky_many under the guard
# ---------------------------------------------------------------------------
def _shift(A, s):
    return sp.csc_matrix(A + s * sp.eye(A.shape[0]))


def test_many_guard_raise_and_perturb():
    A, K = laplacian_2d(10), kkt_saddle(8)
    BF = cholesky_many([A, _shift(A, 1.0)], device="cpu", guard="raise")
    assert all(r.ok for r in BF.guard_reports)
    with pytest.raises(BreakdownError) as ep:
        cholesky_many([K, K.copy()], device="cpu", guard="raise")
    with pytest.raises(ref.BreakdownError) as er:
        ref.cholesky_many([K, K.copy()], device_engine=_xla(), guard="raise")
    assert ep.value.report.first_broken == er.value.report.first_broken
    Ks = [K, _shift(K, 0.5)]
    BF = cholesky_many(Ks, device="cpu", guard="perturb")
    BR = ref.cholesky_many(Ks, device_engine=_xla(), guard="perturb")
    b = np.ones(K.shape[0])
    for i, Ai in enumerate(Ks):
        assert _clamps(BF.guard_reports[i]) == _clamps(BR.guard_reports[i])
        assert _resid(Ai, BF.factor(i).solve(b), b) <= RESID

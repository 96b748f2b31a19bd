"""Fault injection of the port (``repro_torch.faults``) against its engine
fallback chain, its in-kernel guards, its plan cache and the never-crash
serving surface, on the CPU: every scenario of ``tests/test_faults.py``,
each injector asserted to have fired, and each but the perturb stream run
beside the reference's xla route on the same matrices.  Equal across the
two: the ``fired`` kinds, the number of steps down a tier, the guard
reports' broken lanes and first broken level, and the chaos stream's
degraded counters and rejections.
The level at which an injected dispatch failure fires follows each
package's own bucket family, so it is held to the port's schedule."""
import numpy as np
import pytest
import torch
import scipy.sparse as sp

pytest.importorskip("jax")

import repro.core as ref  # noqa: E402
import repro.faults as rfaults  # noqa: E402
from repro.launch import serve as rserve  # noqa: E402

from repro_torch.core import (  # noqa: E402
    BreakdownError,
    DeviceEngine,
    cached_schedule,
    cholesky,
    engines,
)
from repro_torch.core.plan_cache import PlanCache, _plan_nbytes  # noqa: E402
from repro_torch.faults import (  # noqa: E402
    FaultPlan,
    InjectedDispatchError,
    make_indefinite,
    nan_segment,
    poison_plan_file,
)
from repro_torch.kernels import KernelBuildError  # noqa: E402
from repro_torch.launch.serve import (  # noqa: E402
    CholeskyServer,
    run_stream,
    synthetic_stream,
)
from repro_torch.sparse import laplacian_2d  # noqa: E402

_XLA = []


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


def _xla(plan=None):
    """One reference xla engine for the module (its compiled programs are
    shared by every test here), with a fresh fault plan and counters."""
    if not _XLA:
        _XLA.append(ref.DeviceEngine(backend="xla"))
    eng = _XLA[0]
    eng.faults = plan
    eng.fallbacks = {"xla": 0, "host": 0, "failed": 0}
    return eng


def _cpu(plan=None):
    eng = DeviceEngine(device="cpu")
    eng.faults = plan
    return eng


def _resid(A, x, b):
    return float(np.linalg.norm(A @ x - b) / np.linalg.norm(b))


def _kinds(plan):
    return [f[0] for f in plan.fired]


def _guarded(pkg, A, eng):
    """(report, error type name) of one guarded factorization."""
    try:
        return pkg.cholesky(A, device_engine=eng, guard="raise").guard_report, None
    except pkg.BreakdownError as e:
        return e.report, "BreakdownError"


def _broken(rep):
    return ([(b["supernode"] is not None, b["nonfinite"]) for b in rep.broken],
            rep.first_broken_level, rep.ok)


# ---------------------------------------------------------------------------
# engine fallback chain
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ordinal", [1, 3])
def test_fail_dispatch_falls_back(ordinal):
    A = laplacian_2d(9)
    eng = _cpu(FaultPlan(fail_dispatch=ordinal))
    steps0 = dict(engines.STEPS_DOWN)
    F = cholesky(A, device_engine=eng, guard="raise")
    fired = eng.faults.fired
    assert fired and fired[0][0] == "fail_dispatch"
    assert eng.fallbacks == {"plain": 0, "host": 1, "failed": 0}
    assert engines.STEPS_DOWN["host"] == steps0["host"] + 1
    assert F.guard_report.ok
    b = np.ones(A.shape[0])
    assert _resid(A, F.solve(b), b) < 1e-10
    assert ("fallback:host", fired[0][2]) in eng.events
    # the failing dispatch's level, on the port's own schedule
    sched = cached_schedule(F.sym, bucket="fused")
    order = [lvl for lvl, lg in enumerate(sched.groups) for _ in lg]
    assert fired[0] == ("fail_dispatch", ordinal, order[ordinal - 1])
    er = _xla(rfaults.FaultPlan(fail_dispatch=ordinal))
    Fr = ref.cholesky(A, device_engine=er, guard="raise")
    assert _kinds(er.faults) == _kinds(eng.faults)
    assert sum(er.fallbacks.values()) == sum(eng.fallbacks.values())
    assert Fr.guard_report.ok
    np.testing.assert_allclose(F.solve(b), Fr.solve(b), rtol=1e-10,
                               atol=1e-10)


def test_fail_always_reaches_host_tier():
    A = laplacian_2d(9)
    eng = _cpu(FaultPlan(fail_dispatch=1, fail_always=True))
    F = cholesky(A, device_engine=eng, guard="raise")
    ngroups = F.stats["schedule"]["batches"]
    # every group re-factored on the host tier, results still correct
    assert eng.fallbacks == {"plain": 0, "host": ngroups, "failed": 0}
    assert len(eng.faults.fired) == ngroups
    # the host tier counts one transfer out and one in per group
    assert eng.stats["transfers_out"] == 1 + ngroups
    assert F.guard_report.ok
    b = np.ones(A.shape[0])
    assert _resid(A, F.solve(b), b) < 1e-10
    er = _xla(rfaults.FaultPlan(fail_dispatch=1, fail_always=True))
    Fr = ref.cholesky(A, device_engine=er, guard="raise")
    assert Fr.guard_report.ok
    assert set(_kinds(er.faults)) == set(_kinds(eng.faults))
    assert er.fallbacks["host"] == len(er.faults.fired)


def test_fallback_exhaustion_without_host_disabled():
    # sanity: the injected error type is what the chain absorbs
    with pytest.raises(InjectedDispatchError):
        raise InjectedDispatchError("boom")


def test_every_tier_failing_is_counted_and_raises(monkeypatch):
    def host_fails(*_a, **_k):
        raise RuntimeError("host tier down")

    eng = _cpu(FaultPlan(fail_dispatch=1))
    monkeypatch.setattr(eng, "_host_group", host_fails)
    with pytest.raises(InjectedDispatchError):
        cholesky(laplacian_2d(8), device_engine=eng, guard="raise")
    assert eng.fallbacks == {"plain": 0, "host": 1, "failed": 1}
    assert [t for t, _ in eng.events if t.startswith("fallback:")] == \
        ["fallback:host"]


def _with_cuda_tier(monkeypatch, eng):
    """A CPU engine whose chain starts at a ``cuda`` tier, as a card's does
    (its wrapper runs the plain version for CPU tensors)."""
    monkeypatch.setattr(eng, "_group_tiers",
                        lambda: ["cuda", "plain", "host"])
    return eng


@pytest.mark.parametrize("guard", ["off", "raise"])
def test_kernel_tier_error_is_raised_not_served(monkeypatch, guard):
    # only an injected dispatch failure steps down from the kernels; any
    # other error of the cuda tier is counted as failed and propagates
    def refused(*_a, **_k):
        raise RuntimeError("wrapper refused the group")

    monkeypatch.setattr(engines, "fused_factor_syrk", refused)
    eng = _with_cuda_tier(monkeypatch, _cpu())
    steps0 = dict(engines.STEPS_DOWN)
    with pytest.raises(RuntimeError, match="refused"):
        cholesky(laplacian_2d(8), device_engine=eng, guard=guard)
    assert eng.fallbacks == {"plain": 0, "host": 0, "failed": 1}
    assert engines.STEPS_DOWN == steps0
    assert not [t for t, _ in eng.events if t.startswith("fallback:")]


def test_injected_failure_steps_down_from_the_cuda_tier(monkeypatch):
    A = laplacian_2d(9)
    eng = _with_cuda_tier(monkeypatch, _cpu(FaultPlan(fail_dispatch=2)))
    clean = cholesky(A, device_engine=_cpu(), guard="raise")
    F = cholesky(A, device_engine=eng, guard="raise")
    assert eng.faults.fired[0][:2] == ("fail_dispatch", 2)
    assert eng.fallbacks == {"plain": 1, "host": 0, "failed": 0}
    assert F.guard_report.ok
    np.testing.assert_allclose(F.store.storage, clean.store.storage,
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("guard", ["off", "raise"])
def test_kernel_build_error_propagates_uncounted(monkeypatch, guard):
    # a kernel that cannot be built is a broken installation, not a failed
    # dispatch: the first tier's KernelBuildError is never absorbed
    def no_build(*_a, **_k):
        raise KernelBuildError("nvcc not found")

    monkeypatch.setattr(engines, "fused_factor_syrk", no_build)
    eng = _cpu()
    steps0 = dict(engines.STEPS_DOWN)
    with pytest.raises(KernelBuildError):
        cholesky(laplacian_2d(8), device_engine=eng, guard=guard)
    assert eng.fallbacks == {"plain": 0, "host": 0, "failed": 0}
    assert engines.STEPS_DOWN == steps0
    assert not [t for t, _ in eng.events if t.startswith("fallback:")]


# ---------------------------------------------------------------------------
# silent corruption: only the in-kernel guards can catch it
# ---------------------------------------------------------------------------
def test_corrupt_upload_detected_by_guard():
    A = laplacian_2d(9)
    eng = _cpu(FaultPlan(corrupt_upload=1))
    with pytest.raises(BreakdownError) as ei:
        cholesky(A, device_engine=eng, guard="raise")
    assert eng.faults.fired[0][0] == "corrupt_upload"
    assert any(b["nonfinite"] for b in ei.value.report.broken)
    er = _xla(rfaults.FaultPlan(corrupt_upload=1))
    rep, err = _guarded(ref, A, er)
    assert err == "BreakdownError"
    assert _kinds(er.faults) == _kinds(eng.faults)
    assert _broken(rep) == _broken(ei.value.report)


def test_nan_pool_detected_by_guard():
    A = laplacian_2d(9)
    eng = _cpu(FaultPlan(nan_pool_level=0))
    with pytest.raises(BreakdownError) as ei:
        cholesky(A, device_engine=eng, guard="raise")
    assert ("nan_pool", 0) in eng.faults.fired
    # corruption lands after level 0 completes, so breakdown is downstream
    assert ei.value.report.first_broken_level >= 1
    er = _xla(rfaults.FaultPlan(nan_pool_level=0))
    rep, err = _guarded(ref, A, er)
    assert err == "BreakdownError"
    assert er.faults.fired == eng.faults.fired
    assert _broken(rep) == _broken(ei.value.report)


def test_make_indefinite_and_nan_segment():
    A = laplacian_2d(8)
    B = make_indefinite(A, i=3, value=-7.0)
    assert B[3, 3] == -7.0 and (A != B).nnz == 1
    assert (B != rfaults.make_indefinite(A, i=3, value=-7.0)).nnz == 0
    x = np.ones(16)
    y = nan_segment(x.copy(), frac=0.25)
    assert np.isnan(y[:4]).all() and np.isfinite(y[4:]).all()


# ---------------------------------------------------------------------------
# plan-cache faults + LRU eviction
# ---------------------------------------------------------------------------
def test_poisoned_plan_file_rebuilds(tmp_path):
    A = laplacian_2d(12)
    c1 = PlanCache(cache_dir=tmp_path)
    c1.get(A)
    assert c1.stats["misses"] == 1
    poison_plan_file(tmp_path)
    c2 = PlanCache(cache_dir=tmp_path)
    plan = c2.get(A)  # corrupt file rejected, plan rebuilt
    assert c2.disk_rejects == 1 and c2.stats["misses"] == 1
    F = cholesky(A, plan=plan, device="cpu")
    b = np.ones(A.shape[0])
    assert _resid(A, F.solve(b), b) < 1e-10


def test_plan_cache_lru_eviction(tmp_path):
    c = PlanCache(cache_dir=tmp_path, max_bytes=1)  # evict all but newest
    mats = [laplacian_2d(8 + 2 * i) for i in range(3)]
    for A in mats:
        c.get(A)
    assert c.stats["evictions"] >= 2 and len(c) == 1
    # eviction demotes to disk, not oblivion: re-get is a disk hit
    c.get(mats[0])
    assert c.stats["disk_hits"] == 1


def test_plan_cache_lru_keeps_hot_entry():
    A, B, C = laplacian_2d(8), laplacian_2d(10), laplacian_2d(12)
    szC = _plan_nbytes(PlanCache().get(C))
    c = PlanCache(max_bytes=None)
    c.get(A)
    c.get(B)
    c.get(A)  # A is now most-recently-used
    # room for C only after exactly one eviction — the LRU entry (B)
    c.max_bytes = c.nbytes() + szC - 1
    c.get(C)
    assert c.stats["evictions"] == 1
    c.get(A)
    assert c.stats["hits"] == 2  # A (hot) survived, B was the victim


# ---------------------------------------------------------------------------
# chaos: fault-injected server stream, zero uncaught exceptions
# ---------------------------------------------------------------------------
def _chaos_mutate(i, A):
    if i % 5 == 1:
        return make_indefinite(A, i=0, value=-50.0)
    if i % 7 == 3:
        B = sp.lil_matrix(A.copy())
        B[0, 0] = np.nan
        return B.tocsc()
    return A


def _ref_server(tmp_path, guard, plan=None):
    srv = rserve.CholeskyServer(cache_dir=tmp_path, backend="xla",
                                guard=guard)
    srv.engine = _xla(plan)
    return srv


def test_chaos_stream_never_crashes(tmp_path):
    # the reference's scenario on a shorter stream (2 patterns of grids 8
    # and 9, 10 requests), whose seed still mixes breakdowns, bad inputs,
    # batched factors and solves
    kw = dict(requests=10, patterns=2, grid=8, many=2, seed=0)
    srv = CholeskyServer(cache_dir=tmp_path / "port", device="cpu",
                         guard="raise")
    srv.engine.faults = FaultPlan(fail_dispatch=3)
    rep = run_stream(srv, synthetic_stream(**kw), grid=8, seed=0,
                     mutate=_chaos_mutate)
    deg = rep["degraded"]
    assert rep["rejected"] > 0
    assert deg["breakdowns"] > 0 and deg["bad_inputs"] > 0
    assert rep["requests"]["factor_many"] > 0 and rep["requests"]["solve"] > 0
    assert rep.get("max_solve_resid", 0.0) < 1e-8
    # the injected dispatch failure was absorbed by the fallback chain
    assert srv.engine.faults.fired
    assert rep["fallbacks"] == {"plain": 0, "host": 1, "failed": 0}
    rsrv = _ref_server(tmp_path / "ref", "raise",
                       rfaults.FaultPlan(fail_dispatch=3))
    rrep = rserve.run_stream(rsrv, rserve.synthetic_stream(**kw), grid=8,
                             seed=0, mutate=_chaos_mutate)
    assert rrep["degraded"] == deg
    assert rrep["rejected"] == rep["rejected"]
    assert rrep["requests"] == rep["requests"]
    assert _kinds(rsrv.engine.faults) == _kinds(srv.engine.faults)
    assert sum(rrep["fallbacks"].values()) == sum(rep["fallbacks"].values())


def test_chaos_stream_perturb_guard_serves_indefinite(tmp_path):
    # the perturb route itself is held to the reference's in
    # tests/test_torch_guard.py; here the stream serves the indefinite input
    srv = CholeskyServer(cache_dir=tmp_path, device="cpu", guard="perturb")
    reqs = synthetic_stream(requests=8, patterns=2, grid=8, many=2, seed=2)

    def mutate(i, A):
        if i == 2:
            return make_indefinite(A, i=1, value=-9.0)
        return A

    rep = run_stream(srv, reqs, grid=8, seed=2, mutate=mutate)
    assert rep["degraded"]["recovered"] >= 1
    assert rep["rejected"] == 0
    assert rep.get("max_solve_resid", 0.0) < 1e-8
    assert rep["fallbacks"] == {"plain": 0, "host": 0, "failed": 0}


def test_server_handle_structured_errors():
    srv = CholeskyServer(device="cpu", guard="raise")
    A = laplacian_2d(8).tolil()
    A[2, 2] = np.nan
    res = srv.handle("factor", A.tocsc())
    assert not res["ok"] and res["error"]["kind"] == "bad_input"
    brk = srv.handle("factor", make_indefinite(laplacian_2d(8), 0, -3.0))
    assert not brk["ok"] and brk["error"]["kind"] == "breakdown"
    assert "report" in brk["error"]
    assert srv.stats.bad_inputs == 1 and srv.stats.breakdowns == 1
    res = srv.handle("solve", 12345, np.ones(4))  # unknown handle
    assert not res["ok"] and res["error"]["kind"] == "failure"
    rsrv = rserve.CholeskyServer(backend="xla", guard="raise")
    rsrv.engine = _xla()
    rres = rsrv.handle("factor", make_indefinite(laplacian_2d(8), 0, -3.0))
    assert rres["error"]["kind"] == "breakdown"
    # a broken lane's min_pivot is not compared: the reference's guarded
    # route smears the lane's NaN into it (ROADMAP section 3)
    for rep in (rres["error"]["report"], brk["error"]["report"]):
        rep["broken"] = [(b["supernode"], b["level"], b["nonfinite"])
                         for b in rep["broken"]]
    keep = ("guard", "ok", "first_broken", "first_broken_level", "broken")
    assert ({k: rres["error"]["report"][k] for k in keep}
            == {k: brk["error"]["report"][k] for k in keep})

"""The port's plan cache and multi-matrix factorization on the CPU against
the reference: pattern keys and fill plans bit for bit, the ``plan=`` fast
path, the port's own plan file format, LRU eviction and disk demotion,
``cholesky_many`` against the reference's and against single factors,
batched and resident right-hand sides."""
import pickle

import numpy as np
import pytest
import scipy.sparse as sp
import torch

pytest.importorskip("jax")

import repro.core as ref  # noqa: E402
import repro.sparse as rsparse  # noqa: E402
from repro.core.plan_cache import build_fill_plan as ref_fill  # noqa: E402

from repro_torch.core import (  # noqa: E402
    BatchCholeskyFactor,
    CachedPlan,
    DeviceEngine,
    PlanCache,
    build_fill_plan,
    cached_plan_from_arrays,
    canonical_csc,
    cholesky,
    cholesky_many,
    counters,
    device_solve,
    init_panel_store,
    pattern_fingerprint,
    symbolic_pipeline,
)
from repro_torch.core.plan_cache import _plan_nbytes  # noqa: E402
from repro_torch.sparse import laplacian_2d, laplacian_3d  # noqa: E402

#: the five generators of tests/test_torch_plan.py
GENERATORS = [
    ("laplacian_2d", {"nx": 24}),
    ("laplacian_3d", {"nx": 8}),
    ("elasticity_3d", {"nx": 5}),
    ("kkt_like", {"nx": 16}),
    ("random_spd", {"n": 80, "density": 0.06, "seed": 4}),
]


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


def _cpu():
    return DeviceEngine(device="cpu")


def _family(A0, m):
    """m SPD matrices with A0's pattern and distinct values (the
    reference's tests/test_many.py family)."""
    n = A0.shape[0]
    out = []
    for i in range(m):
        rng = np.random.default_rng(100 + i)
        B = sp.csc_matrix(A0).copy()
        B.data = B.data * (1.0 + 0.05 * rng.standard_normal(B.nnz))
        B = (B + B.T) * 0.5
        out.append(sp.csc_matrix(B + (1.0 + 0.3 * i) * n * sp.eye(n)))
    return out


def _resid(A, x, b):
    return float(np.linalg.norm(A @ x - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# keys and fill plans, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("gen,kw", GENERATORS)
def test_fingerprint_and_fill_plan_match_reference(gen, kw):
    A = canonical_csc(getattr(rsparse, gen)(**kw))
    assert pattern_fingerprint(A) == ref.pattern_fingerprint(A)
    sym, Aperm = symbolic_pipeline(A)
    src, dst = build_fill_plan(sym, A)
    rsrc, rdst = ref_fill(ref.symbolic_pipeline(A)[0], A)
    for a, b in ((src, rsrc), (dst, rdst)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    plan = CachedPlan(key=pattern_fingerprint(A), sym=sym, fill_src=src,
                      fill_dst=dst, n=A.shape[0], nnz=int(A.nnz))
    np.testing.assert_array_equal(plan.fill_storage(A),
                                  init_panel_store(sym, Aperm).storage)


def test_fill_storage_rejects_wrong_pattern():
    plan = PlanCache().get(laplacian_2d(6))
    with pytest.raises(ValueError, match="does not match"):
        plan.fill_storage(laplacian_2d(7))


def test_plan_fast_path_is_bit_identical_and_rebuilds_nothing():
    A = laplacian_2d(14)
    cache = PlanCache()
    plan = cache.get(A)
    eng = _cpu()
    F0 = cholesky(A, device_engine=eng)
    Fw = cholesky(A, plan=plan, device_engine=eng)
    np.testing.assert_array_equal(Fw.store.storage, F0.store.storage)
    Fw.solve(np.ones(A.shape[0]), backend="device")
    A3 = _family(A, 2)[1]
    before = counters.snapshot()
    plan3 = cache.get(A3)
    assert plan3 is plan
    F = cholesky(A3, plan=plan3, device_engine=eng)
    x = F.solve(np.ones(A.shape[0]), backend="device")
    assert counters.delta(before) == {}, counters.delta(before)
    assert cache.stats["misses"] == 1 and cache.stats["hits"] == 1
    assert _resid(A3, x, np.ones(A.shape[0])) < 1e-12


def test_reference_plan_carried_across():
    A = rsparse.kkt_like(nx=10)
    rp = ref.PlanCache().get(A)
    s = rp.sym
    plan = cached_plan_from_arrays(
        rp.key, rp.fill_src, rp.fill_dst, rp.n, rp.nnz, perm=s.perm,
        parent=s.parent, super_ptr=s.super_ptr, rows=s.rows, snode=s.snode,
        sparent=s.sparent, colcount=s.colcount)
    own = PlanCache().get(A)
    assert plan.key == own.key
    assert np.array_equal(plan.fill_src, own.fill_src)
    assert np.array_equal(plan.fill_dst, own.fill_dst)
    Fa = cholesky(A, plan=plan, device="cpu")
    Fb = cholesky(A, plan=own, device="cpu")
    np.testing.assert_array_equal(Fa.store.storage, Fb.store.storage)


# ---------------------------------------------------------------------------
# the port's plan file
# ---------------------------------------------------------------------------
def test_save_load_round_trip_and_rejections(tmp_path):
    A = laplacian_3d(5)
    plan = PlanCache().get(A)
    F_mem = cholesky(A, plan=plan, device="cpu")
    path = plan.save(tmp_path)
    loaded = CachedPlan.load(path, expect_key=plan.key)
    before = counters.snapshot()
    F_disk = cholesky(A, plan=loaded, device="cpu")
    assert counters.delta(before) == {}
    np.testing.assert_array_equal(F_disk.store.storage, F_mem.store.storage)

    env = pickle.loads(path.read_bytes())
    with pytest.raises(ValueError, match="wrong plan"):
        CachedPlan.load(path, expect_key="0" * 32)
    bad = tmp_path / "tampered.pkl"
    bad.write_bytes(pickle.dumps(dict(env, blob=env["blob"][:-1] + b"x")))
    with pytest.raises(ValueError, match="corrupt"):
        CachedPlan.load(bad)
    stale = tmp_path / "stale.pkl"
    stale.write_bytes(pickle.dumps(dict(env, version=env["version"] + 1)))
    with pytest.raises(ValueError, match="format version"):
        CachedPlan.load(stale)
    # a file of the reference's format is rejected before its payload (which
    # names the reference's classes) is unpickled
    theirs = ref.PlanCache().get(A).save(tmp_path / "reference.pkl")
    with pytest.raises(ValueError, match="format"):
        CachedPlan.load(theirs)


def test_plan_cache_lru_eviction_and_disk_demotion(tmp_path):
    c = PlanCache(cache_dir=tmp_path, max_bytes=1)  # evict all but newest
    mats = [laplacian_2d(8 + 2 * i) for i in range(3)]
    for A in mats:
        c.get(A)
    assert c.stats["evictions"] >= 2 and len(c) == 1
    # eviction demotes to disk, not oblivion: a re-get is a disk hit
    before = counters.snapshot()
    c.get(mats[0])
    assert c.stats["disk_hits"] == 1 and counters.delta(before) == {}
    # a second cache on the same directory loads instead of analysing
    c2 = PlanCache(cache_dir=tmp_path)
    plan = c2.get(mats[1])
    assert c2.stats == {"hits": 0, "misses": 0, "disk_hits": 1,
                        "evictions": 0}
    b = np.ones(mats[1].shape[0])
    F = cholesky(mats[1], plan=plan, device="cpu")
    assert _resid(mats[1], F.solve(b), b) < 1e-12


def test_plan_cache_lru_keeps_hot_entry():
    A, B, C = laplacian_2d(8), laplacian_2d(10), laplacian_2d(12)
    szC = _plan_nbytes(PlanCache().get(C))
    c = PlanCache(max_bytes=None)
    c.get(A)
    c.get(B)
    c.get(A)  # A is now most recently used
    c.max_bytes = c.nbytes() + szC - 1  # room for C after one eviction
    c.get(C)
    assert c.stats["evictions"] == 1
    c.get(A)
    assert c.stats["hits"] == 2  # A (hot) survived, B was the victim


# ---------------------------------------------------------------------------
# cholesky_many
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("gen,kw,m", [
    ("laplacian_2d", {"nx": 10}, 3),
    ("kkt_like", {"nx": 10}, 2),
])
def test_cholesky_many_matches_reference_and_single(gen, kw, m):
    As = _family(getattr(rsparse, gen)(**kw), m)
    rplan = ref.PlanCache().get(As[0])
    BR = ref.cholesky_many(As, device_engine=ref.DeviceEngine(backend="xla"),
                           plan=rplan)
    plan = PlanCache().get(As[0])
    eng = _cpu()
    BF = cholesky_many(As, device_engine=eng, plan=plan)
    assert isinstance(BF, BatchCholeskyFactor) and BF.nmat == m
    scale = np.max(np.abs(BR.storage[:, :-1]))
    np.testing.assert_allclose(BF.storage[:, :-1], BR.storage[:, :-1],
                               rtol=0, atol=1e-10 * scale)
    # one dispatch per group for all m matrices, one read-back
    nb = BF.stats["schedule"]["batches"]
    assert eng.stats["device_calls"] == nb and eng.stats["transfers_out"] == 1
    for i, A in enumerate(As):
        Fi = cholesky(A, plan=plan, device="cpu")
        np.testing.assert_allclose(BF.storage[i][:-1], Fi.store.storage[:-1],
                                   rtol=1e-12, atol=1e-13)
        b = np.random.default_rng(i).standard_normal(A.shape[0])
        assert _resid(A, BF.factor(i).solve(b), b) < 1e-10


def test_cholesky_many_stats_match_reference_pallas():
    # the reference's fused-family plan runs only on its pallas route
    A = rsparse.laplacian_2d(6)
    As = [A, sp.csc_matrix(A + sp.eye(A.shape[0]))]
    er = ref.DeviceEngine(backend="pallas")
    BR = ref.cholesky_many(As, device_engine=er)
    ep = _cpu()
    BF = cholesky_many(As, device_engine=ep)
    assert BF.stats == BR.stats
    # every count the reference keeps, equal; the port's one extra count is
    # the shared index plan's share of bytes_in, one int32 upload of it
    assert {k: ep.stats[k] for k in er.stats} == er.stats
    assert set(ep.stats) - set(er.stats) == {"index_bytes_in"}
    assert ep.stats["index_bytes_in"] == 12288
    np.testing.assert_allclose(BF.storage, BR.storage, rtol=0,
                               atol=1e-12 * np.max(np.abs(BR.storage)))


@pytest.mark.parametrize("nrhs", [None, 4])
def test_many_solve(nrhs):
    As = _family(laplacian_3d(5), 3)
    n = As[0].shape[0]
    eng = _cpu()
    BF = cholesky_many(As, device_engine=eng)
    shape = (3, n) if nrhs is None else (3, n, nrhs)
    b = np.random.default_rng(3).standard_normal(shape)
    calls = eng.stats["device_calls"]
    x = BF.solve(b)
    assert x.shape == b.shape
    nl = BF.stats["schedule"]["levels"]
    # every level is one dispatch for all matrices (plus the inversions)
    assert eng.stats["device_calls"] - calls == \
        2 * nl + BF.stats["schedule"]["batches"]
    for i, A in enumerate(As):
        assert _resid(A, x[i], b[i]) < 1e-12
        np.testing.assert_allclose(x[i], BF.factor(i).solve(b[i]),
                                   rtol=1e-10, atol=1e-12)


def test_resident_rhs_solve_zero_transfers():
    As = _family(laplacian_2d(12), 2)
    n = As[0].shape[0]
    eng = _cpu()
    BF = cholesky_many(As, device_engine=eng)
    b = np.random.default_rng(4).standard_normal((2, n, 3))
    x_host = BF.solve(b)
    t = (eng.stats["transfers_in"], eng.stats["transfers_out"])
    xd = BF.solve(torch.from_numpy(b))
    assert (eng.stats["transfers_in"], eng.stats["transfers_out"]) == t
    assert isinstance(xd, torch.Tensor)
    np.testing.assert_array_equal(xd.numpy(), x_host)
    xd2 = BF.solve(xd)  # chain on the resident result
    assert isinstance(xd2, torch.Tensor)
    assert (eng.stats["transfers_in"], eng.stats["transfers_out"]) == t
    # one matrix: a resident (n,) and (n, k) right-hand side
    A = laplacian_2d(12)
    F = cholesky(A, device_engine=eng)
    bb = np.random.default_rng(5).standard_normal((n, 2))
    xh, xh1 = F.solve(bb, backend="device"), F.solve(bb[:, 0],
                                                        backend="device")
    t = (eng.stats["transfers_in"], eng.stats["transfers_out"])
    xr = device_solve(F.dstore, torch.from_numpy(bb))
    xr1 = device_solve(F.dstore, torch.from_numpy(bb[:, 0].copy()))
    assert (eng.stats["transfers_in"], eng.stats["transfers_out"]) == t
    np.testing.assert_array_equal(xr.numpy(), xh)
    np.testing.assert_array_equal(xr1.numpy(), xh1)

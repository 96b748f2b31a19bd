"""A plan's device index tensors stay resident on the engine (CPU), in two
entries: the groups' index arrays and the read-back's storage order, made
on the device from them.  A refactorization of a known pattern uploads no
index bytes and counts a hit on each,
its factor and its solves are bit for bit a fresh engine's, no store writes
into the shared tensors, the entry dies with its plan, and an out-of-memory
upload drops the other entries and succeeds on its retry."""
import gc

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro_torch.core import DeviceEngine, PlanCache, cholesky, cholesky_many
from repro_torch.core.device_store import _KINDS
from repro_torch.sparse import laplacian_2d, laplacian_3d


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small ops (as in
    ``test_torch_serve.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu() -> DeviceEngine:
    return DeviceEngine(device="cpu")


def _values(A, k: int) -> sp.csc_matrix:
    """New values on the pattern of ``A`` (the diagonal is in it)."""
    return sp.csc_matrix(A * (1.0 + 0.25 * k) + k * sp.eye(A.shape[0]))


def _index_bytes(gp, kinds=_KINDS) -> int:
    return sum(getattr(g, k).nbytes for lvl in gp.groups for g in lvl
               for k in kinds)


@pytest.mark.parametrize("guard", ["off", "raise"])
def test_refactor_hits_the_resident_index(guard):
    A = laplacian_3d(5)
    plan = PlanCache().get(A)
    eng = _cpu()
    F1 = cholesky(A, plan=plan, device_engine=eng, guard=guard)
    gp = F1.dstore.plan
    assert eng.stats["index_bytes_in"] == _index_bytes(gp) > 0
    assert eng.index_cache["misses"] == 2 and eng.index_cache["hits"] == 0
    st0 = dict(eng.stats)
    A2 = _values(A, 1)
    F2 = cholesky(A2, plan=plan, device_engine=eng, guard=guard)
    grew = {k: eng.stats[k] - st0[k] for k in st0}
    assert grew["index_bytes_in"] == 0
    # only the values crossed: 8 bytes a packed cell
    assert grew["bytes_in"] == 8 * gp.packed_total
    assert eng.index_cache["hits"] == 2 and eng.index_cache["misses"] == 2
    # the two stores share the index tensors, each in its own groups
    g1, g2 = F1.dstore.groups[0][0], F2.dstore.groups[0][0]
    assert g1 is not g2 and g1.gidx is g2.gidx
    Ff = cholesky(A2, plan=plan, device_engine=_cpu(), guard=guard)
    np.testing.assert_array_equal(F2.store.storage, Ff.store.storage)
    if guard == "raise":
        assert F2.guard_report.ok


@pytest.mark.parametrize("first", ["single", "many"])
def test_solves_after_a_hit_are_a_fresh_engines(first):
    """A device solve through shared index tensors, after another store of
    the plan has solved on the same engine (a single factor, or a
    two-matrix ``cholesky_many`` whose solve rebases its own cols/tails),
    is bit for bit a fresh engine's."""
    A = laplacian_2d(12)
    n = A.shape[0]
    plan = PlanCache().get(A)
    eng = _cpu()
    rng = np.random.default_rng(7)
    if first == "single":
        F0 = cholesky(A, plan=plan, device_engine=eng)
        F0.solve(rng.standard_normal(n), backend="device")
    else:
        BF = cholesky_many([A, _values(A, 2)], plan=plan, device_engine=eng)
        BF.solve(rng.standard_normal((2, n, 3)))
    A2 = _values(A, 1)
    F = cholesky(A2, plan=plan, device_engine=eng)
    assert eng.index_cache["hits"] == 2 and eng.index_cache["misses"] == 2
    Ff = cholesky(A2, plan=plan, device_engine=_cpu())
    np.testing.assert_array_equal(F.store.storage, Ff.store.storage)
    b = rng.standard_normal((n, 2))
    np.testing.assert_array_equal(F.solve(b, backend="device"),
                                  Ff.solve(b, backend="device"))
    np.testing.assert_array_equal(F.solve(b[:, 0], backend="device"),
                                  Ff.solve(b[:, 0], backend="device"))


@pytest.mark.parametrize("how", ["released", "evicted"])
def test_the_entry_dies_with_its_plan(how):
    A = laplacian_2d(10)
    eng = _cpu()
    cache = PlanCache(max_bytes=1)  # keeps only the newest plan
    F = cholesky(A, plan=cache.get(A), device_engine=eng)
    nb = eng.index_cache["resident_bytes"]
    # the int64 flat tensor, each group's int32 rows and ws, and the int64
    # storage order of every packed cell
    groups = [g for lvl in F.dstore.plan.groups for g in lvl]
    assert nb == sum(8 * getattr(g, k).size for g in groups for k in _KINDS) \
        + sum(4 * (g.rows_arr.size + g.ws_arr.size) for g in groups) \
        + 8 * F.dstore.plan.packed_total
    del F
    if how == "released":
        del cache
    else:
        cache.get(laplacian_2d(11))  # evicts the first plan
        assert cache.stats["evictions"] == 1 and len(cache) == 1
    gc.collect()
    assert eng.index_cache["resident_bytes"] == 0
    assert eng._index == {}


def test_an_out_of_memory_upload_drops_the_others_and_retries(monkeypatch):
    eng = _cpu()
    B = laplacian_2d(9)
    FB = cholesky(B, plan=PlanCache().get(B), device_engine=eng)
    assert len(eng._index) == 2
    real, calls = eng.put_index, []

    def flaky(x):
        calls.append(x.nbytes)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("out of memory (injected)")
        return real(x)

    monkeypatch.setattr(eng, "put_index", flaky)
    A = laplacian_3d(5)
    plan = PlanCache().get(A)
    st0 = dict(eng.stats)
    F = cholesky(A, plan=plan, device_engine=eng)
    assert len(calls) == 2
    # B's entries went; B's factor still holds its tensors and solves
    assert len(eng._index) == 2 and eng.index_cache["misses"] == 4
    gp = F.dstore.plan
    assert eng.stats["index_bytes_in"] - st0["index_bytes_in"] == \
        _index_bytes(gp)
    Ff = cholesky(A, plan=plan, device_engine=_cpu())
    np.testing.assert_array_equal(F.store.storage, Ff.store.storage)
    b = np.ones(B.shape[0])
    assert np.linalg.norm(B @ FB.solve(b, backend="device") - b) < 1e-10
    # the next factor of A is a hit: no index upload
    n_calls = len(calls)
    cholesky(_values(A, 1), plan=plan, device_engine=eng)
    assert eng.index_cache["hits"] == 2 and len(calls) == n_calls

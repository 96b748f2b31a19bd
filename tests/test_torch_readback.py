"""The factor read-back (CPU, and one check on the card): the packed factor
is reordered into storage order on the device and lands in the engine's
reused landing buffer, then in the storage with one contiguous copy.  The
storage is bit for bit what the host scatter ``storage[..., cells_concat]
= packed[..., :-2]`` made from the same resident factor, the trash cell is
untouched, the guard's status blocks are the same, and it stays one
transfer a factorization.  The reorder index is a resident entry made on
the device (no index bytes cross), and the landing buffer grows once and
never aliases a factor handed to the caller.

On the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_readback.py``."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro_torch.core import DeviceEngine, PlanCache, cholesky
from repro_torch.core.device_store import DevicePanelStore
from repro_torch.core.schedule import cached_schedule
from repro_torch.launch.serve import CholeskyServer
from repro_torch.sparse import elasticity_3d, laplacian_3d

#: the benchmark configurations' CPU sizes (poisson3d_48, elasticity3d_32),
#: then the sizes ``test_torch_slice.py`` runs
MATRICES = [(laplacian_3d, 6), (elasticity_3d, 4),
            (laplacian_3d, 8), (elasticity_3d, 5)]
SMALL = MATRICES[:2]
_IDS = [f"{gen.__name__}-{nx}" for gen, nx in MATRICES]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small ops (as in
    ``test_torch_serve.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _values(A, k: int) -> sp.csc_matrix:
    """New values on the pattern of ``A`` (the diagonal is in it)."""
    return sp.csc_matrix(A * (1.0 + 0.25 * k) + k * sp.eye(A.shape[0]))


def _factor_on_device(eng, A, nmat: int, guard: bool):
    """A store of ``nmat`` value sets of ``A``'s pattern, factored level by
    level as ``numeric`` drives it, and its storage, before the read-back."""
    plan = PlanCache().get(A)
    sym = plan.sym
    storage = (plan.fill_storage(A) if nmat == 1 else
               np.stack([plan.fill_storage(_values(A, k))
                         for k in range(nmat)]))
    sched = cached_schedule(sym, bucket="fused")
    ds = DevicePanelStore(eng, sym, sched, storage, nmat=nmat, guard=guard)
    for lvl, lgroups in enumerate(sched.groups):
        ds.prefetch_level(lvl + 1)
        for gi in range(len(lgroups)):
            ds.assemble_group(lvl, gi)
    ngroups = sum(len(lg) for lg in sched.groups)
    return ds, storage, ngroups


@pytest.mark.parametrize("nmat", [1, 3])
@pytest.mark.parametrize("guard", [False, True], ids=["off", "raise"])
@pytest.mark.parametrize("gen,nx", MATRICES, ids=_IDS)
def test_read_back_is_the_host_scatter(gen, nx, guard, nmat):
    A = gen(nx)
    eng = DeviceEngine(device="cpu")
    ds, storage, ngroups = _factor_on_device(eng, A, nmat, guard)
    ds.finalize()
    packed = ds.factor_ext.numpy().copy()
    lead = (nmat,) if nmat > 1 else ()
    status = [st.numpy().copy() for st in ds._status]
    storage[..., -1] = -7.25  # the trash cell: left as it is
    want = storage.copy()
    want[..., ds.plan.cells_concat] = packed[..., :-2]
    st0 = dict(eng.stats)
    ds.read_into(storage)
    np.testing.assert_array_equal(storage, want)
    assert np.all(storage[..., -1] == -7.25)
    grew = {k: eng.stats[k] - st0[k] for k in st0}
    assert grew["transfers_out"] == 1 and grew["transfers_in"] == 0
    # the packed factor, its zero and one cells and the status blocks
    assert grew["bytes_out"] == 8 * (
        packed.size + sum(s.size for s in status))
    assert eng.stats["device_calls"] == ngroups
    if not guard:
        assert ds.guard_status() is None
        return
    got = ds.guard_status()
    assert len(got) == len(status) == ngroups
    for g, s in zip(got, status):
        np.testing.assert_array_equal(g, s.reshape(lead + (-1, 4)))
    # the status blocks are the store's own, not the engine's buffer
    assert not np.shares_memory(got[0], eng._landing.numpy())


def test_the_reorder_index_is_the_plans_storage_order():
    A = elasticity_3d(4)
    eng = DeviceEngine(device="cpu")
    ds, _, _ = _factor_on_device(eng, A, 1, False)
    np.testing.assert_array_equal(ds._order.numpy(), ds.plan.cells_concat)
    assert ds._order.dtype == torch.int64


@pytest.mark.parametrize("guard", ["off", "raise"])
@pytest.mark.parametrize("gen,nx", SMALL, ids=_IDS[:2])
def test_a_refactor_reuses_the_landing_buffer(gen, nx, guard):
    A = gen(nx)
    plan = PlanCache().get(A)
    eng = DeviceEngine(device="cpu")
    F1 = cholesky(A, plan=plan, device_engine=eng, guard=guard)
    panels1 = [p.copy() for p in F1.panels]
    storage1 = F1.store.storage.copy()
    st0 = dict(eng.stats)
    F2 = cholesky(_values(A, 1), plan=plan, device_engine=eng, guard=guard)
    grew = {k: eng.stats[k] - st0[k] for k in st0}
    assert grew["index_bytes_in"] == 0 and grew["transfers_out"] == 1
    nb = F2.stats["schedule"]["batches"]
    assert grew["device_calls"] == nb
    assert eng.readback["grows"] == 1 and eng.readback["reads"] == 2
    assert eng.readback["pinned_bytes"] == eng._landing.nbytes
    # the first factor is its own: the second read-back left it alone
    land = eng._landing.numpy()
    for F in (F1, F2):
        assert not np.shares_memory(F.store.storage, land)
    np.testing.assert_array_equal(F1.store.storage, storage1)
    for p, q in zip(F1.panels, panels1):
        np.testing.assert_array_equal(p, q)
    assert not np.array_equal(F2.store.storage, storage1)
    Ff = cholesky(_values(A, 1), plan=plan,
                  device_engine=DeviceEngine(device="cpu"), guard=guard)
    np.testing.assert_array_equal(F2.store.storage, Ff.store.storage)


def test_the_server_reports_the_read_back():
    A = laplacian_3d(6)
    srv = CholeskyServer(device="cpu", guard="off")
    for k in range(3):
        h = srv.handle("factor", _values(A, k))["result"]
        srv.release(h)
    rb = srv.report()["readback"]
    assert (rb["grows"], rb["reads"]) == (1, 3)
    assert rb["pinned_bytes"] == srv.engine._landing.nbytes > 0


@pytest.mark.cuda
def test_the_landing_buffer_is_pinned_and_reused_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    A = elasticity_3d(5)
    plan = PlanCache().get(A)
    eng = DeviceEngine(device="cuda")
    ptrs = []
    for k in range(3):
        F = cholesky(_values(A, k), plan=plan, device_engine=eng,
                     guard="raise")
        assert eng._landing.is_pinned()
        ptrs.append(eng._landing.data_ptr())
    assert len(set(ptrs)) == 1
    assert eng.readback["grows"] == 1 and eng.readback["reads"] == 3
    # bit for bit the host scatter of the resident factor
    want = F.store.storage.copy()
    want[..., F.dstore.plan.cells_concat] = \
        F.dstore.factor_ext.cpu().numpy()[..., :-2]
    np.testing.assert_array_equal(F.store.storage, want)
    Fc = cholesky(_values(A, 2), plan=plan,
                  device_engine=DeviceEngine(device="cpu"), guard="raise")
    scale = np.max(np.abs(Fc.store.storage))
    np.testing.assert_allclose(F.store.storage, Fc.store.storage, rtol=0,
                               atol=1e-10 * scale)

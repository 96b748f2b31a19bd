"""The whole first slice of the port on the CPU against the reference:
``repro_torch`` ``cholesky(A, device="cpu")`` and its device solve against
``repro`` ``cholesky(A, device_engine=DeviceEngine(backend=...))`` and the
solve of that factor.

The factor is the same math under either bucket family, so storage and
solves are compared with the reference's xla route (the ``batch`` family);
the dispatch and transfer counts are checked against the reference's
``fused``-family plan, which the port uses.  The storage tolerance,
1e-10 * max|L|, comes from the prefix-sum assembly both packages share
(src/repro/core/device_store.py: about one digit of residual), not from
machine epsilon.  One tiny matrix also goes through the reference's pallas
route (Pallas in interpret mode, same ``fused`` family): there stats and
events must be equal and the storage agree to 1e-12 * max|L|."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import repro.core as ref  # noqa: E402
import repro.sparse as rsparse  # noqa: E402

from repro_torch.core import (  # noqa: E402
    DeviceEngine,
    cholesky,
    storage_from_array,
    symbolic_from_arrays,
)

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


def _port_sym(s):
    """Hand the reference's analysis to the port."""
    return symbolic_from_arrays(s.n, s.perm, s.parent, s.super_ptr, s.rows,
                                s.snode, s.sparent, s.colcount)


@pytest.mark.parametrize("gen,kw", GENERATORS)
def test_slice_matches_reference_xla(gen, kw):
    A = getattr(rsparse, gen)(**kw)
    Fr = ref.cholesky(A, device_engine=ref.DeviceEngine(backend="xla"))
    eng = DeviceEngine(device="cpu")
    Fp = cholesky(A, device_engine=eng, sym=_port_sym(Fr.sym))
    sr = storage_from_array(Fr.store.storage)
    scale = np.max(np.abs(sr))
    np.testing.assert_allclose(Fp.store.storage, sr, rtol=0,
                               atol=1e-10 * scale)
    b = np.random.default_rng(1).standard_normal((A.shape[0], 3))
    # the reference factor's host solve: its device solve would only add
    # per-level jit compiles, not another check
    xr = Fr.solve(b)
    for x in (Fp.solve(b, backend="device"), Fp.solve(b[:, 0],
                                                     backend="device"),
              Fp.solve(b)):
        xx = x if x.ndim == 2 else x[:, None]
        xe = xr if x.ndim == 2 else xr[:, :1]
        assert np.linalg.norm(xx - xe) <= 1e-10 * np.linalg.norm(xe)
    # structure: one dispatch per group of the reference's fused-family plan
    sched = ref.cached_schedule(Fr.sym, bucket="fused")
    st = Fp.stats["schedule"]
    assert (st["batches"], st["levels"]) == (sched.n_batches, sched.n_levels)
    n_lev = sched.n_levels
    # after the two device solves: one dispatch per group (factor) and per
    # group (diagonal inversion), 2 per level per solve
    assert eng.stats["device_calls"] == 2 * sched.n_batches + 2 * 2 * n_lev
    assert eng.stats["transfers_in"] == 1 + n_lev + 1 + 2
    assert eng.stats["transfers_out"] == 1 + 2


@pytest.mark.parametrize("staging", ["async", "sync"])
def test_factor_counts_and_event_order(staging):
    A = rsparse.laplacian_3d(8)
    eng = DeviceEngine(device="cpu")
    F = cholesky(A, device_engine=eng, staging=staging)
    nb, nl = F.stats["schedule"]["batches"], F.stats["schedule"]["levels"]
    assert eng.stats["device_calls"] == nb
    assert eng.stats["transfers_in"] == 1 + (nl if staging == "async" else 1)
    assert eng.stats["transfers_out"] == 1
    ev = list(eng.events)
    assert ev.count(("dispatch", 0)) == len(F.sym.schedules[(256, 1 << 24,
                                                              "fused")]
                                            .groups[0])
    if staging == "async":
        for k in range(nl - 1):  # level k+1's upload before level k runs
            assert ev.index(("upload", k + 1)) < ev.index(("dispatch", k))
    else:
        assert not any(t == "upload" for t, _ in ev)
    x = F.solve(np.ones(A.shape[0]), backend="device")
    assert np.linalg.norm(A @ x - 1.0) <= 1e-12 * np.sqrt(A.shape[0])


def test_slice_matches_reference_pallas_kkt8():
    A = rsparse.kkt_like(8)
    er = ref.DeviceEngine(backend="pallas")
    Fr = ref.cholesky(A, device_engine=er)
    ep = DeviceEngine(device="cpu")
    Fp = cholesky(A, device_engine=ep)
    # every count the reference keeps, equal; the port's one extra count is
    # the index plan's share of bytes_in, one int32 upload of it
    assert {k: ep.stats[k] for k in er.stats} == er.stats
    assert set(ep.stats) - set(er.stats) == {"index_bytes_in"}
    assert ep.stats["index_bytes_in"] == 34072
    assert list(ep.events) == list(er.events)
    scale = np.max(np.abs(Fr.store.storage))
    np.testing.assert_allclose(Fp.store.storage, Fr.store.storage, rtol=0,
                               atol=1e-12 * scale)
    b = np.random.default_rng(2).standard_normal(A.shape[0])
    xr, xp = Fr.solve(b, backend="device"), Fp.solve(b, backend="device")
    assert np.linalg.norm(xp - xr) <= 1e-12 * np.linalg.norm(xr)
    for k in ("transfers_in", "transfers_out", "device_calls"):
        assert ep.stats[k] == er.stats[k], k


def test_forward_solve_accumulates_duplicate_tail_rows():
    """Two lanes of one group share a tail row (sibling supernodes share
    ancestor rows); the forward level must add both contributions."""
    eng = DeviceEngine(device="cpu")
    n = 5
    rng = np.random.default_rng(0)
    P = np.zeros((2, 4, 2))
    P[:, :2, :2] = np.eye(2)
    P[:, 2:, :] = rng.standard_normal((2, 2, 2))
    cols = np.array([[0, 1], [2, 3]])
    tails = np.array([[4, n], [4, n]])  # row 4 in both lanes, pad -> trash
    y0 = np.concatenate([rng.standard_normal((n, 1)), np.zeros((1, 1))])
    expect = y0.copy()
    for b in range(2):
        expect[tails[b, 0]] -= P[b, 2] @ y0[cols[b]]
    y = eng.solve_fwd_level(
        torch.from_numpy(y0.copy()), torch.tensor([n]),
        [torch.from_numpy(P)], [torch.eye(2, dtype=torch.float64).expand(2, 2, 2)],
        [torch.from_numpy(cols)], [torch.from_numpy(tails)])
    np.testing.assert_allclose(y.numpy()[:n], expect[:n], rtol=1e-14,
                               atol=1e-14)
    assert y[n, 0] == 0.0  # trash row reset


def test_storage_and_symbolic_carry_across():
    A = rsparse.laplacian_2d(12)
    Fr = ref.cholesky(A)  # the reference's host RL factorization
    sym = _port_sym(Fr.sym)
    store = storage_from_array(Fr.store.storage, sym)
    for pr, pp in zip(Fr.panels, store.panels):
        assert np.array_equal(pr, pp)
    with pytest.raises(ValueError):
        storage_from_array(Fr.store.storage[:-1], sym)

"""The paper's sequential RL/RLB offload paths, the mixed host/device levels
path and the device solve of a host factor, in the port on the CPU against
the reference.

Each route runs ``repro_torch`` ``cholesky(A, device="cpu", ...)`` and the
reference's ``cholesky`` with a ``DeviceEngine`` on the same analysis.
Factors are compared panel by panel at the reference's own offload
tolerance (rtol 1e-10, atol 1e-9: tests/test_offload.py:33); the pallas
route (Pallas in interpret mode) at 1e-12 relative to max |L|.  The
factorization ``stats`` must be equal, and so must the engine's transfer
and dispatch counts; the engine's byte counts differ by design, since the
port stages a supernode's exact panel where the reference stages a padded
bucket.  Host-only factorizations run the same numpy code in both packages
and must agree bit for bit."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import repro.core as ref  # noqa: E402
import repro.sparse as rsparse  # noqa: E402
from conftest import make_spd  # noqa: E402

from repro_torch.core import (  # noqa: E402
    CholeskyFactor,
    DeviceEngine,
    cholesky,
    factorize_rl,
    factorize_rlb,
    solve,
    storage_from_array,
    symbolic_from_arrays,
)
from repro_torch.sparse import laplacian_2d  # noqa: E402

COUNTS = ("transfers_in", "transfers_out", "device_calls")


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
    return symbolic_from_arrays(s.n, s.perm, s.parent, s.super_ptr, s.rows,
                                s.snode, s.sparent, s.colcount)


def _analysis(A):
    sym, Ap = ref.symbolic_pipeline(A)
    return A, sym, Ap, _port_sym(sym)


@pytest.fixture(scope="module")
def lap10():
    return _analysis(rsparse.laplacian_3d(10))


@pytest.fixture(scope="module")
def kkt12():
    return _analysis(rsparse.kkt_like(12))


@pytest.fixture(scope="module")
def ref_engines():
    """One reference xla engine per ``fused`` setting for the whole module,
    so its jitted programs compile once; stats are zeroed before each use."""
    return {f: ref.DeviceEngine(backend="xla", fused=f) for f in (True, False)}


def _zeroed(eng):
    for k in eng.stats:
        eng.stats[k] = 0
    return eng


def _same_factor(Fp, Fr, rtol=1e-10, atol=1e-9):
    assert len(Fp.panels) == len(Fr.panels)
    for pp, pr in zip(Fp.panels, Fr.panels):
        np.testing.assert_allclose(pp, pr, rtol=rtol, atol=atol)


def _same_counts(ep, er):
    assert {k: ep.stats[k] for k in COUNTS} == {k: er.stats[k] for k in COUNTS}


def _run_seq(case, ref_eng, method, bt, fused, thr):
    A, sym, Ap, psym = case
    er = _zeroed(ref_eng)
    Fr = ref.cholesky(A, method=method, sym=sym, Aperm=Ap, schedule="seq",
                      device_engine=er, offload_threshold=thr,
                      batch_transfers=bt)
    ep = DeviceEngine(device="cpu", fused=fused)
    Fp = cholesky(A, method=method, sym=psym, Aperm=Ap, schedule="seq",
                  device_engine=ep, offload_threshold=thr,
                  batch_transfers=bt)
    _same_factor(Fp, Fr)
    assert Fp.stats == Fr.stats
    _same_counts(ep, er)
    assert ep.stats["transfers_in"] == Fp.stats["supernodes_on_device"] > 0
    return Fp


@pytest.mark.parametrize("thr", [0, 2000])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("method,bt", [("rl", False), ("rlb", False),
                                       ("rlb", True)])
def test_seq_matches_reference_xla(lap10, ref_engines, method, bt, fused,
                                   thr):
    Fp = _run_seq(lap10, ref_engines[fused], method, bt, fused, thr)
    if thr == 0:
        assert Fp.stats["supernodes_on_device"] == Fp.stats["supernodes_total"]
    else:
        assert 0 < Fp.stats["supernodes_on_device"] < Fp.stats["supernodes_total"]


@pytest.mark.parametrize("method,bt,fused,thr", [
    ("rl", False, False, 0),
    ("rlb", False, True, 2000),
    ("rlb", True, False, 0),
])
def test_seq_matches_reference_xla_kkt(kkt12, ref_engines, method, bt, fused,
                                       thr):
    _run_seq(kkt12, ref_engines[fused], method, bt, fused, thr)


@pytest.mark.parametrize("method,fused", [("rl", False), ("rlb", False),
                                          ("rl", True)])
def test_seq_matches_reference_pallas(method, fused):
    A, sym, Ap, psym = _analysis(make_spd(60, 0.08, 4))
    er = ref.DeviceEngine(backend="pallas", fused=fused)
    Fr = ref.cholesky(A, method=method, sym=sym, Aperm=Ap, schedule="seq",
                      device_engine=er, offload_threshold=0)
    ep = DeviceEngine(device="cpu", fused=fused)
    Fp = cholesky(A, method=method, sym=psym, Aperm=Ap, schedule="seq",
                  device_engine=ep, offload_threshold=0)
    scale = max(np.abs(p).max() for p in Fr.panels)
    _same_factor(Fp, Fr, rtol=0, atol=1e-12 * scale)
    assert Fp.stats == Fr.stats
    _same_counts(ep, er)


@pytest.mark.parametrize("case", ["lap10", "kkt12"])
def test_host_only_factors_are_bit_identical(case, request):
    A, sym, Ap, psym = request.getfixturevalue(case)
    for port, reference in ((factorize_rl, ref.factorize_rl),
                            (factorize_rlb, ref.factorize_rlb)):
        Fp, Fr = port(psym, Ap), reference(sym, Ap)
        assert np.array_equal(Fp.store.storage, Fr.store.storage)
        assert Fp.stats == Fr.stats
        assert Fp.engine is None


@pytest.mark.parametrize("kw", [{"offload_threshold": 2000},
                                {"assembly": "host"},
                                {"assembly": "host", "offload_threshold": 500}])
def test_mixed_levels_matches_reference(kkt12, kw):
    A, sym, Ap, psym = kkt12
    er = ref.DeviceEngine(backend="xla")
    Fr = ref.cholesky(A, sym=sym, Aperm=Ap, schedule="levels",
                      device_engine=er, **kw)
    ep = DeviceEngine(device="cpu")
    Fp = cholesky(A, sym=psym, Aperm=Ap, device_engine=ep, **kw)
    assert Fp.stats["assembly"] == "host"
    _same_factor(Fp, Fr)
    assert Fp.stats == Fr.stats
    _same_counts(ep, er)
    assert 0 < Fp.stats["supernodes_on_device"]


def test_host_factor_device_solve():
    A = rsparse.laplacian_3d(8)
    b = np.random.default_rng(0).standard_normal((A.shape[0], 2))
    # a sequential factor of the port: its engine stages it on first use
    F = cholesky(A, device="cpu", schedule="seq", offload_threshold=600_000)
    assert F.dstore is None
    for x in (F.solve(b, backend="device"), F.solve(b[:, 0],
                                                    backend="device")):
        xx = x if x.ndim == 2 else x[:, None]
        bb = b if x.ndim == 2 else b[:, :1]
        assert np.linalg.norm(A @ xx - bb) <= 1e-10 * np.linalg.norm(bb)
    # staged once: index arrays + packed factor + trash row, then per solve
    # one RHS up and one solution down
    assert F.engine.stats["transfers_in"] == 3 + 2
    assert F.engine.stats["transfers_out"] == 2
    # the reference's host factor, carried across as flat storage
    Fr = ref.cholesky(A)
    psym = _port_sym(Fr.sym)
    store = storage_from_array(Fr.store.storage, psym)
    Fx = CholeskyFactor(sym=psym, panels=store.panels, store=store)
    x = Fx.solve(b, backend="device", engine=DeviceEngine(device="cpu"))
    assert np.linalg.norm(A @ x - b) <= 1e-10 * np.linalg.norm(b)
    np.testing.assert_allclose(x, Fr.solve(b), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("kw", [{"schedule": "seq"},
                                {"offload_threshold": 600_000},
                                {"method": "rlb"},
                                {"method": "rlb", "schedule": "seq"},
                                {"method": "rlb", "schedule": "seq",
                                 "batch_transfers": True}])
def test_formerly_unported_routes_run(kw):
    A = laplacian_2d(6)
    b = np.ones(A.shape[0])
    x = solve(A, b, device="cpu", solve_backend="device", **kw)
    assert np.linalg.norm(A @ x - b) <= 1e-12 * np.linalg.norm(b)


@pytest.mark.parametrize("kw,match", [
    ({"method": "rlb", "batch_transfers": True}, "batch_transfers"),
    ({"schedule": "seq", "assembly": "host"}, "assembly"),
    ({"schedule": "seq", "staging": "sync"}, "staging"),
    ({"offload_threshold": 2000, "staging": "sync"}, "staging"),
])
def test_misuse_raises_as_in_the_reference(kw, match):
    A = laplacian_2d(6)
    with pytest.raises(ValueError, match=match):
        ref.cholesky(A, device_engine=ref.DeviceEngine(), **kw)
    with pytest.raises(ValueError, match=match):
        cholesky(A, device="cpu", **kw)

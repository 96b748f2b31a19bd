"""The three-dispatch oracle of the port (``DeviceEngine(fused_groups=
False)``: ``gather_group``, ``factor_group`` and ``pack_group`` per group,
on the reference's "batch" family unless a family is named) on the CPU:
three engine calls per group, panels within 1e-12 of the one-dispatch path
and of the reference's own oracle (its xla route, on the same family),
equal bit for bit to the one-dispatch path on its own "fused" family,
within the prefix sums' rounding of it on "batch", and the reference's
refusals (guard, multi-matrix and async staging need fused groups)."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import repro.core as ref  # noqa: E402

from repro_torch.core import (  # noqa: E402
    DeviceEngine,
    cholesky,
    cholesky_many,
    symbolic_pipeline,
)
from repro_torch.core.engines import ordered_cumsum  # noqa: E402
from repro_torch.core.numeric import _factorize_levels_device  # noqa: E402
from repro_torch.sparse import kkt_like, laplacian_2d, laplacian_3d  # noqa: E402

TOL = 1e-12


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


def _close(P, Q):
    for p, q in zip(P, Q):
        np.testing.assert_allclose(p, q, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("gen,kw", [(laplacian_3d, {"nx": 6}),
                                    (kkt_like, {"nx": 8})],
                         ids=["lap3d", "kkt"])
def test_three_dispatch_oracle_matches_fused_and_reference(gen, kw):
    A = gen(**kw)
    sym, Ap = symbolic_pipeline(A)
    eng1 = DeviceEngine(device="cpu")
    F1 = cholesky(A, sym=sym, Aperm=Ap, device_engine=eng1)
    eng3 = DeviceEngine(device="cpu", fused_groups=False)
    F3 = cholesky(A, sym=sym, Aperm=Ap, device_engine=eng3)
    batches = F3.stats["schedule"]["batches"]
    assert F3.stats["dispatches_per_group"] == 3
    assert F1.stats["dispatches_per_group"] == 1
    assert F3.stats["bucket"] == "batch"
    assert F1.stats["bucket"] == "fused"
    assert F3.stats["staging"] == "sync"
    assert eng3.stats["device_calls"] == 3 * batches
    # the whole storage and the index plan up, the factor back: one each
    assert eng3.stats["transfers_in"] == 2
    assert eng3.stats["transfers_out"] == 1
    _close(F3.panels, F1.panels)
    rsym, rAp = ref.symbolic_pipeline(A)
    eng_r = ref.DeviceEngine(backend="xla", fused_groups=False)
    Fr = ref.cholesky(A, sym=rsym, Aperm=rAp, device_engine=eng_r)
    assert Fr.stats["dispatches_per_group"] == 3
    assert eng_r.stats["device_calls"] == 3 * Fr.stats["schedule"]["batches"]
    assert F3.stats["schedule"] == Fr.stats["schedule"]
    _close(F3.panels, Fr.panels)
    b = np.ones(A.shape[0])
    x = F3.solve(b, backend="device")
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-10


@pytest.mark.parametrize("nx", [6, 12])
def test_three_dispatch_oracle_on_the_fused_family_is_bit_equal(nx):
    # on the one-dispatch path's own schedule the oracle runs the same
    # prefix sums and the same factor: the same bits
    A = laplacian_3d(nx)
    sym, Ap = symbolic_pipeline(A)
    F1 = cholesky(A, sym=sym, Aperm=Ap, device_engine=DeviceEngine(
        device="cpu"))
    eng3 = DeviceEngine(device="cpu", fused_groups=False)
    F3 = _factorize_levels_device(sym, Ap, eng3, bucket="fused")
    assert F3.stats["schedule"] == F1.stats["schedule"]
    assert eng3.stats["device_calls"] == 3 * F3.stats["schedule"]["batches"]
    assert np.array_equal(F3.store.storage, F1.store.storage)


@pytest.mark.parametrize("nx", [8, 16])
def test_batch_oracle_within_the_prefix_sums_rounding(nx):
    # the "batch" family groups the prefix sums otherwise: the panels move
    # by at most 4u (P_batch + P_fused), P each oracle's largest running
    # total (the bound the card's smoke holds lap3d_40 to)
    A = laplacian_3d(nx)
    sym, Ap = symbolic_pipeline(A)
    F1 = cholesky(A, sym=sym, Aperm=Ap, device_engine=DeviceEngine(
        device="cpu"))
    peaks, panels = {}, {}
    for family in ("batch", "fused"):
        eng3 = DeviceEngine(device="cpu", fused_groups=False)
        F3 = _factorize_levels_device(sym, Ap, eng3, bucket=family)
        peaks[family] = float(eng3.scan_peak)
        panels[family] = F3.store.storage
    assert peaks["batch"] > 0 and peaks["fused"] > 0
    tol = 4 * 2.0 ** -53 * (peaks["batch"] + peaks["fused"])
    assert np.max(np.abs(panels["batch"] - F1.store.storage)) <= tol
    assert np.array_equal(panels["fused"], F1.store.storage)


def test_three_dispatch_refusals():
    A = laplacian_2d(8)
    eng3 = DeviceEngine(device="cpu", fused_groups=False)
    with pytest.raises(ValueError, match="fused groups"):
        cholesky(A, device_engine=eng3, guard="raise")
    with pytest.raises(ValueError, match="fused groups"):
        cholesky(A, device_engine=eng3, staging="async")
    with pytest.raises(ValueError, match="fused groups"):
        cholesky_many([A, A], device_engine=eng3)
    # the reference refuses the same three
    eng_r = ref.DeviceEngine(backend="xla", fused_groups=False)
    for call in (lambda: ref.cholesky(A, device_engine=eng_r, guard="raise"),
                 lambda: ref.cholesky(A, device_engine=eng_r,
                                      staging="async"),
                 lambda: ref.cholesky_many([A, A], device_engine=eng_r)):
        with pytest.raises(ValueError, match="fused groups"):
            call()


@pytest.mark.parametrize("M,n", [(1, 0), (1, 1), (2, 5), (1, 1024),
                                 (3, 1025), (1, 5000), (2, 1024 ** 2 + 7)])
def test_ordered_cumsum_is_cumsum(M, n):
    # the group assembly's prefix sums, added up block by block (a fixed
    # order on the card, where one long row's scan is not): the running
    # sums of torch.cumsum to within rounding of the running total
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((M, n)))
    got, want = ordered_cumsum(x), torch.cumsum(x, 1)
    assert got.shape == want.shape
    if n:
        scale = x.abs().sum(1).max()
        assert float((got - want).abs().max()) <= 1e-15 * float(scale)

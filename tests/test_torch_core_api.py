"""The port's ``repro_torch.core`` surface against the reference's
``repro.core``: every exported name, and the factor's ``logdet()`` and
``factor_nnz()`` on the same input, on the CPU.  ``logdet`` is held to the
reference's value at 1e-12 relative (both sum the logs of the same
diagonal, computed by the same host arithmetic or the plain versions of the
port's kernels) and to ``slogdet``, as the reference's own test
(``tests/test_merge_refine.py::test_logdet_matches_slogdet``) holds it."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import repro.core as ref  # noqa: E402
import repro.sparse as rsparse  # noqa: E402

import repro_torch.core as port  # noqa: E402
from repro_torch.core import DeviceEngine  # noqa: E402

#: names of ``repro.core.__all__`` the port does not export yet, each with
#: the ROADMAP item that ports it (none left)
NOT_PORTED: dict = {}


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


def test_core_exports_every_reference_name():
    missing = set(ref.__all__) - set(port.__all__) - set(NOT_PORTED)
    assert not missing, sorted(missing)
    for name in port.__all__:
        assert getattr(port, name) is not None


@pytest.mark.parametrize("gen,kw,method,engine", [
    ("random_spd", {"n": 90, "density": 0.05, "seed": 11}, "rlb", False),
    ("laplacian_3d", {"nx": 7}, "rl", False),
    ("kkt_like", {"nx": 10}, "rl", True),
])
def test_logdet_and_factor_nnz_match_reference(gen, kw, method, engine):
    A = getattr(rsparse, gen)(**kw)
    Fr = ref.cholesky(A, method=method)
    if engine:   # the levels path through the kernels' plain versions
        Fp = port.cholesky(A, device_engine=DeviceEngine(device="cpu"))
    else:
        Fp = port.cholesky(A, method=method, device="cpu")
    assert Fp.factor_nnz() == Fr.factor_nnz()
    want = Fr.logdet()
    assert abs(Fp.logdet() - want) <= 1e-12 * max(abs(want), 1.0)
    sign, ld = np.linalg.slogdet(A.toarray())
    assert sign > 0
    assert abs(Fp.logdet() - ld) < 1e-8 * max(abs(ld), 1)

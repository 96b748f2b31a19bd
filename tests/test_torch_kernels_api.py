"""The port's ``repro_torch.kernels`` surface against the reference's
``repro.kernels``: every exported name, and the package's ``potrf`` (the
blocked routine, not its submodule) on the same SPD matrix within 1e-12 of
``repro.kernels.potrf(A, backend="xla")``, on the CPU."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import repro.core  # noqa: E402,F401  (turns on x64, as the solver does)
import repro.kernels as ref  # noqa: E402

import repro_torch.kernels as port  # noqa: E402

#: names of ``repro.kernels.__all__`` the port does not export, by design:
#: the reference's pure-jnp oracles module; the port's oracles are the
#: ``*_ref`` plain versions beside each wrapper
BY_DESIGN = {"ref": "the oracles are the port's *_ref names"}


def test_kernels_export_every_reference_name():
    missing = set(ref.__all__) - set(port.__all__) - set(BY_DESIGN)
    assert not missing, sorted(missing)
    assert not set(BY_DESIGN) & set(port.__all__)
    for name in port.__all__:
        assert getattr(port, name) is not None
    assert callable(port.potrf) and port.potrf is port.ops.potrf
    for mp in (0, 7, 64, 96, 200, 256):
        assert port.syrk_tile(mp) == ref.syrk_tile(mp)


def test_potrf_matches_reference():
    rng = np.random.default_rng(0)
    M = rng.standard_normal((40, 40))
    A = M @ M.T + 40.0 * np.eye(40)
    want = np.asarray(ref.potrf(A, backend="xla"))
    got = port.potrf(torch.from_numpy(A)).numpy()
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))
    assert np.allclose(np.triu(got, 1), 0.0)

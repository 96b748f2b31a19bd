"""Kernel checks that need an NVIDIA card (marker ``cuda``; skipped without
one).  Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each CUDA kernel is held against its plain PyTorch version at small odd
shapes the main path does not reach (partial 64-wide blocks, Wp not a power
of two, garbage pad cells), to 1e-10 relative; the wrappers' argument checks
raise; and a small factorization on the card matches the CPU run."""
import numpy as np
import pytest
import torch

from repro_torch.core import DeviceEngine, cholesky
from repro_torch.kernels import (
    fused_factor_syrk,
    fused_factor_syrk_ref,
    tri_inv_lower,
    tri_inv_lower_ref,
)
from repro_torch.sparse import kkt_like, laplacian_3d

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(x, ref):
    return float((x - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


def _group(extents, Lp, Wp, seed):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((len(extents), Lp, Wp))
    for i, (r, w) in enumerate(extents):
        if w:
            G = rng.standard_normal((w, w))
            lo = np.tril_indices(w)
            p[i, :w, :w][lo] = (G @ G.T / w + 2 * np.eye(w))[lo]
    rows = np.array([r for r, _ in extents], np.int32)
    ws = np.array([w for _, w in extents], np.int32)
    return p, rows, ws


@pytest.mark.parametrize("extents,Lp,Wp", [
    ([(20, 8), (16, 16), (9, 1), (0, 0)], 32, 16),
    ([(8, 8), (5, 5)], 8, 8),
    ([(300, 100), (150, 64), (101, 99), (0, 0)], 320, 100),
    ([(700, 130), (257, 200)], 768, 256),
])
def test_fused_kernel_matches_plain(card, extents, Lp, Wp):
    p, rows, ws = (torch.from_numpy(a).to(card)
                   for a in _group(extents, Lp, Wp, 0))
    before = fused_factor_syrk.launches
    fp, u = fused_factor_syrk(p, rows, ws)
    torch.cuda.synchronize()
    assert fused_factor_syrk.launches == before + 1
    fr, ur = fused_factor_syrk_ref(p, rows, ws)
    assert _rel(fp, fr) <= 1e-10
    if Lp > Wp:
        assert _rel(u, ur) <= 1e-10


@pytest.mark.parametrize("Bp,Wp", [(3, 8), (2, 40), (2, 64), (2, 100),
                                   (1, 300)])
def test_tri_inv_kernel_matches_plain(card, Bp, Wp):
    rng = np.random.default_rng(Wp)
    L = np.tril(rng.standard_normal((Bp, Wp, Wp)) / np.sqrt(Wp))
    idx = np.arange(Wp)
    L[:, idx, idx] = 1.0 + np.abs(rng.standard_normal((Bp, Wp)))
    L = torch.from_numpy(L).to(card)
    X = tri_inv_lower(L)
    torch.cuda.synchronize()
    assert _rel(X, tri_inv_lower_ref(L)) <= 1e-10
    assert not torch.triu(X, 1).any()


def test_wrappers_check_their_arguments(card):
    p = torch.zeros((2, 16, 8), dtype=torch.float64, device=card)
    r = torch.zeros(2, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        fused_factor_syrk(p, r.long(), r)
    with pytest.raises(ValueError):
        fused_factor_syrk(p.float(), r, r)
    with pytest.raises(ValueError):
        fused_factor_syrk(p.transpose(1, 2), r, r)
    with pytest.raises(ValueError):
        tri_inv_lower(p)


@pytest.mark.parametrize("make", [lambda: laplacian_3d(8),
                                  lambda: kkt_like(12)])
def test_small_factor_on_card_matches_cpu(card, make):
    A = make()
    Fg = cholesky(A, device_engine=DeviceEngine(device=card))
    Fc = cholesky(A, device="cpu", sym=Fg.sym)
    scale = np.abs(Fc.store.storage).max()
    assert np.abs(Fg.store.storage - Fc.store.storage).max() <= 1e-10 * scale
    b = np.random.default_rng(0).standard_normal((A.shape[0], 2))
    x = Fg.solve(b, backend="device")
    assert np.linalg.norm(A @ x - b) <= 1e-10 * np.linalg.norm(b)

"""Each cell's inputs come from the seed alone, and the frozen count of
the work is the count the port's records quote."""
import numpy as np
import pytest
import scipy.sparse as sp

from cholbench import bench, work
from cholbench.testing import small_cell

SPEC = bench.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def _inputs(name, seed, spec=SPEC, root=bench.ROOT):
    cell = small_cell(spec, name, root)
    A = cell.generator.make(**cell.cfg["params"])
    st = cell.loop.prepare(A, cell.cfg, cell.traffic, seed)
    arrays = [A.data, A.indices, A.indptr, st.order]
    if hasattr(st, "sets"):
        arrays += st.sets + st.warm_sets
        arrays += [st.values(i)[2] for i in range(2 * len(st.sets))]
    if hasattr(st, "pool"):
        arrays += [st.pool, st.A.data]
    return arrays


@pytest.mark.parametrize("name", CELLS)
def test_inputs_repeat_for_a_seed_and_differ_for_another(name):
    big = 2 ** 31 + 12345
    a, b, c = _inputs(name, big), _inputs(name, big), _inputs(name, big + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    # the pattern stays, the values and the order move
    assert all(np.array_equal(x, y) for x, y in zip(a[1:3], c[1:3]))
    assert any(not np.array_equal(x, y) for x, y in zip(a[3:], c[3:]))


@pytest.mark.parametrize("name", CELLS)
def test_value_sets_keep_the_pattern_and_symmetry(name):
    cell = small_cell(SPEC, name)
    A = cell.generator.make(**cell.cfg["params"])
    st = cell.loop.prepare(A, cell.cfg, cell.traffic, 7)
    M = st.vs.matrix(st.vs.draw(np.random.default_rng(1)))
    assert np.array_equal(M.indptr, A.indptr)
    assert np.array_equal(M.indices, A.indices)
    assert abs(M - M.T).max() == 0
    assert np.all(np.linalg.eigvalsh(M.toarray()) > 0)


@pytest.mark.parametrize("gen,nx,n,nnz,bw", [
    ("laplacian_3d", 48, 110_592, 760_320, 2_304),
    ("elasticity_3d", 32, 98_304, 2_009_088, 3_074),
])
def test_configurations_matrices(gen, nx, n, nnz, bw):
    from cholbench.reference import bandwidth

    mod = bench.load_file(bench.HERE / "matrices" / f"{gen}.py")
    A = mod.make(nx)
    assert A.shape == (n, n) and A.nnz == nnz and bandwidth(A) == bw
    assert abs(A - A.T).max() == 0


def test_flop_count_on_lap3d_40():
    from cholbench.matrices import laplacian_3d
    from repro_torch.core import symbolic_pipeline

    sym, _ = symbolic_pipeline(laplacian_3d.make(40))
    w, r = work.shapes(sym)
    assert work.factor_flops(w, r) / 1e9 == pytest.approx(13.35, abs=0.005)
    # w^3/3 + m w^2 + m^2 w, the smoke's count, is its leading part
    m = (r - w).astype(float)
    lead = float(np.sum(w ** 3 / 3 + m * w * w + m * m * w))
    assert lead / 1e9 == pytest.approx(13.33, abs=0.005)


def test_counts_against_a_dense_factor():
    from repro_torch.core import cholesky

    A = sp.csc_matrix(np.array([[4.0, 1, 0, 1], [1, 4, 1, 0], [0, 1, 4, 1],
                                [1, 0, 1, 4]]))
    F = cholesky(A, device="cpu")
    w, r = work.shapes(F.sym)
    brute = sum(float(rr - k) ** 2 for ww, rr in zip(w, r)
                for k in range(ww))
    assert work.factor_flops(w, r) == brute
    # the stored rectangles less the strict upper triangles of their
    # diagonal blocks
    assert work.factor_cells(w, r) == F.factor_nnz() - np.sum(w * (w - 1) // 2)
    assert work.solve_bytes(w, r, 4, 2) == 8 * (work.factor_cells(w, r)
                                                + 16)

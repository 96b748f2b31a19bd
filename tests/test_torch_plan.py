"""Plan parity between the reference package and the PyTorch port: symbolic
analysis, scatter plan, level schedule, flop accounting and every device
index array must be bit-identical for both bucket families."""
import numpy as np
import pytest

pytest.importorskip("jax")

import repro.core as ref  # noqa: E402
import repro.sparse as rsparse  # noqa: E402

import repro_torch.core as port  # noqa: E402
import repro_torch.sparse as psparse  # noqa: E402

GENERATORS = [
    ("laplacian_2d", {"nx": 24}),
    ("laplacian_3d", {"nx": 8}),
    ("elasticity_3d", {"nx": 5}),
    ("kkt_like", {"nx": 16}),
    ("random_spd", {"n": 80, "density": 0.06, "seed": 4}),
]


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert np.array_equal(a, b), what


@pytest.mark.parametrize("bucket", ["batch", "fused"])
@pytest.mark.parametrize("gen,kw", GENERATORS)
def test_plan_stack_bit_identical(gen, kw, bucket):
    A = getattr(rsparse, gen)(**kw)
    Ap = getattr(psparse, gen)(**kw)
    assert (A != Ap).nnz == 0
    sr, Pr = ref.symbolic_pipeline(A)
    sp_, Pp = port.symbolic_pipeline(Ap)
    assert sr.n == sp_.n
    for f in ("perm", "parent", "super_ptr", "snode", "sparent"):
        _equal(getattr(sr, f), getattr(sp_, f), f)
    assert (sr.colcount is None) == (sp_.colcount is None)
    assert len(sr.rows) == len(sp_.rows)
    for s, (a, b) in enumerate(zip(sr.rows, sp_.rows)):
        _equal(a, b, f"rows[{s}]")
    for f in ("indptr", "indices", "data"):
        _equal(getattr(Pr, f), getattr(Pp, f), f"Aperm.{f}")

    plr, plp = ref.scatter_plan(sr), port.scatter_plan(sp_)
    _equal(plr.offs, plp.offs, "offs")
    assert plr.trash == plp.trash
    for s, (a, b) in enumerate(zip(plr.dst, plp.dst)):
        _equal(a, b, f"dst[{s}]")

    shr = ref.cached_schedule(sr, bucket=bucket)
    shp = port.cached_schedule(sp_, bucket=bucket)
    _equal(shr.levels, shp.levels, "levels")
    assert [[(g.level, g.Lp, g.Wp) for g in lg] for lg in shr.groups] == \
        [[(g.level, g.Lp, g.Wp) for g in lg] for lg in shp.groups]
    for lr, lp in zip(shr.groups, shp.groups):
        for gr, gp in zip(lr, lp):
            _equal(gr.ids, gp.ids, "ids")
    assert shr.batch_stats() == shp.batch_stats()
    assert ref.group_flop_stats(sr, shr) == port.group_flop_stats(sp_, shp)

    dr, dp = ref.device_plan(sr, shr), port.device_plan(sp_, shp)
    for f in ("cells_concat", "level_base"):
        _equal(getattr(dr, f), getattr(dp, f), f)
    assert (dr.packed_total, dr.pool_size) == (dp.packed_total, dp.pool_size)
    fields = [f for f in dr.groups[0][0].__dataclass_fields__]
    for lr, lp in zip(dr.groups, dp.groups):
        assert len(lr) == len(lp)
        for gr, gp in zip(lr, lp):
            for f in fields:
                a, b = getattr(gr, f), getattr(gp, f)
                if isinstance(a, np.ndarray):
                    _equal(a, b, f)
                else:
                    assert a == b, f


@pytest.mark.parametrize("rows,w", [(1, 1), (9, 1), (20, 8), (300, 130),
                                    (2048, 1890), (4000, 600), (70, 64)])
def test_bucket_functions_match(rows, w):
    from repro.core.engines import _bucket_batch
    from repro.kernels.fused import syrk_tile

    from repro_torch.core.buckets import _bucket_batch as pbb

    assert ref.bucket_shape(rows, w) == port.bucket_shape(rows, w)
    assert ref.bucket_shape_batch(rows, w) == port.bucket_shape_batch(rows, w)
    assert ref.bucket_shape_fused(rows, w) == port.bucket_shape_fused(rows, w)
    assert _bucket_batch(rows) == pbb(rows)
    assert syrk_tile(rows) == port.syrk_tile(rows)

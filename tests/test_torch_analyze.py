"""The port's static analysis (``repro_torch.analyze``) on the CPU: the plan
lint, hazard and cache tests of ``tests/test_analyze.py`` (its kernel pass
is not ported yet).  Clean plans prove clean, and every seeded violation is
caught; each mutation is applied to the port's plan and to the
reference's (the plans are bit-identical), and the findings' severities,
codes and locations must be the reference's.  Also here: the lint gate of
``CachedPlan.load`` and the server's verify mode."""
import copy
import pickle

import numpy as np
import pytest
import scipy.sparse as sp

pytest.importorskip("jax")

import repro.analyze as ranalyze  # noqa: E402
import repro.core as ref  # noqa: E402
from repro.analyze.plan_lint import _pool_destinations as r_pool_dest  # noqa: E402
from repro.core.device_store import device_plan as r_device_plan  # noqa: E402
from repro.core.relind import scatter_plan as r_scatter_plan  # noqa: E402
from repro.core.schedule import cached_schedule as r_cached_schedule  # noqa: E402

from repro_torch.analyze import (  # noqa: E402
    AnalysisReport,
    audit_engine,
    audit_trace,
    check_plan_file,
    lint_device_plan,
    lint_fill_plan,
    lint_plan_stack,
    lint_scatter_plan,
    lint_schedule,
    plan_happens_before,
    traced_factorization,
)
from repro_torch.analyze.plan_lint import _pool_destinations  # noqa: E402
from repro_torch.core import (  # noqa: E402
    CachedPlan,
    DeviceEngine,
    PlanCache,
    build_fill_plan,
    cached_schedule,
    canonical_csc,
    cholesky,
    device_plan,
    pattern_fingerprint,
    scatter_plan,
    symbolic_pipeline,
)
from repro_torch.launch.serve import CholeskyServer  # noqa: E402
from repro_torch.sparse import (  # noqa: E402
    elasticity_3d,
    kkt_like,
    laplacian_2d,
    laplacian_3d,
    random_spd,
)

GENERATORS = [
    pytest.param(laplacian_2d, {"nx": 20}, id="lap2d"),
    pytest.param(laplacian_2d, {"nx": 12, "stencil": 9}, id="lap2d9"),
    pytest.param(laplacian_3d, {"nx": 6}, id="lap3d"),
    pytest.param(laplacian_3d, {"nx": 5, "stencil": 27}, id="lap3d27"),
    pytest.param(elasticity_3d, {"nx": 3}, id="elast3d"),
    pytest.param(kkt_like, {"nx": 12}, id="kkt"),
    pytest.param(random_spd, {"n": 120, "density": 0.03, "seed": 1},
                 id="rand"),
]
FAMILY = "fused"  # the port's device-resident family


def _errors(findings):
    return [f for f in findings if f.severity == "error"]


def _codes(findings):
    return {f.code for f in findings}


def _key(findings):
    return sorted((f.severity, f.pass_name, f.code, f.location)
                  for f in findings)


class _Plans:
    """One matrix's symbolic factor, schedule and device plan in both
    packages."""

    def __init__(self, A):
        self.A = canonical_csc(A)
        self.sym, _ = symbolic_pipeline(self.A)
        self.sched = cached_schedule(self.sym, max_batch=256, bucket=FAMILY)
        self.gp = device_plan(self.sym, self.sched)
        self.rsym, _ = ref.symbolic_pipeline(self.A)
        self.rsched = r_cached_schedule(self.rsym, max_batch=256,
                                        bucket=FAMILY)
        self.rgp = r_device_plan(self.rsym, self.rsched)


@pytest.fixture(scope="module")
def lap():
    return _Plans(laplacian_2d(16))


def _both(port, reference):
    """Port findings, held to the reference's on the same mutation."""
    assert _key(port) == _key(reference)
    return port


# ---------------------------------------------------------------------------
# clean plans prove clean
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fn,kw", GENERATORS)
def test_all_generators_zero_errors(fn, kw):
    A = canonical_csc(fn(**kw))
    sym, _ = symbolic_pipeline(A)
    fs, fd = build_fill_plan(sym, A)
    findings = lint_plan_stack(sym, buckets=("batch", "fused"),
                               fill=(fs, fd), nnz=int(A.nnz))
    for family in ("batch", "fused"):
        findings += plan_happens_before(
            sym, cached_schedule(sym, max_batch=256, bucket=family))
    assert _errors(findings) == [], "\n".join(str(f) for f in findings)


def test_report_statuses(lap):
    rep = AnalysisReport(target="lap2d_16[fused]")
    rep.extend(lint_plan_stack(lap.sym, buckets=(FAMILY,)))
    rep.extend(plan_happens_before(lap.sym, lap.sched, lap.gp))
    assert rep.status("plan-lint") == "PASS"
    assert rep.status("hazard") == "PASS"
    assert rep.status() == "PASS"
    rep.extend(audit_trace([("dispatch", 0)], n_levels=1))
    assert rep.status("hazard") == "FAIL" and rep.errors


# ---------------------------------------------------------------------------
# pass 1 mutations: corrupted index plans are caught, precisely
# ---------------------------------------------------------------------------
def _big_supernode(sym, min_m=2):
    for s in range(sym.nsuper):
        m = sym.rows[s].shape[0] - sym.width(s)
        if m >= min_m:
            return s, m
    pytest.skip("no supernode with enough tail rows")


def _scatter_mutation(lap, mutate):
    s, m = _big_supernode(lap.sym)
    plan = copy.deepcopy(scatter_plan(lap.sym))
    rplan = copy.deepcopy(r_scatter_plan(lap.rsym))
    mutate(plan, s, m)
    mutate(rplan, s, m)
    return _both(lint_scatter_plan(lap.sym, plan),
                 ranalyze.lint_scatter_plan(lap.rsym, rplan))


def test_scatter_oob_caught(lap):
    def mut(plan, s, m):
        plan.dst[s][0] = plan.trash + 7  # lower-tri entry past real storage

    assert "scatter-oob" in _codes(_errors(_scatter_mutation(lap, mut)))


def test_scatter_upper_not_trash_caught(lap):
    def mut(plan, s, m):
        plan.dst[s][1] = 0  # entry (0,1) is strict-upper: must be trash

    assert "upper-not-trash" in _codes(_errors(_scatter_mutation(lap, mut)))


def test_scatter_dup_caught(lap):
    def mut(plan, s, m):
        D = plan.dst[s].reshape(m, m)
        D[1, 0] = D[0, 0]  # two update entries land on one cell

    assert "scatter-dup" in _codes(_errors(_scatter_mutation(lap, mut)))


def test_scatter_wrong_cell_caught(lap):
    # in-bounds, unique, but the WRONG cell: the semantic re-derivation
    # (decode destination back to ancestor row/column) must catch it
    def mut(plan, s, m):
        D = plan.dst[s].reshape(m, m)
        a, b = int(D[0, 0]), int(D[1, 1])
        D[0, 0], D[1, 1] = b, a  # swap two diagonal destinations

    codes = _codes(_errors(_scatter_mutation(lap, mut)))
    assert codes & {"dest-column", "dest-row"}


def test_fill_plan_mutations_caught(lap):
    A = lap.A
    fs, fd = build_fill_plan(lap.sym, A)
    rfs, rfd = ref.build_fill_plan(lap.rsym, A)
    np.testing.assert_array_equal(fs, rfs)
    np.testing.assert_array_equal(fd, rfd)
    nnz = int(A.nnz)
    assert lint_fill_plan(lap.sym, fs, fd, nnz) == []

    def both(src, dst):
        return _both(lint_fill_plan(lap.sym, src, dst, nnz),
                     ranalyze.lint_fill_plan(lap.rsym, src, dst, nnz))

    bad = fd.copy()
    bad[0] = scatter_plan(lap.sym).trash  # route a fill into the trash cell
    assert "fill-dst-oob" in _codes(both(fs, bad))
    bad = fd.copy()
    bad[0] = bad[1]
    assert "fill-dup" in _codes(both(fs, bad))
    bad = fs.copy()
    bad[0] = nnz + 3
    assert "fill-src-oob" in _codes(both(bad, fd))


def test_schedule_tampered_levels_caught(lap):
    sparent = np.asarray(lap.sym.sparent)
    child = int(np.flatnonzero(sparent >= 0)[0])
    sched = copy.deepcopy(lap.sched)
    rsched = copy.deepcopy(lap.rsched)
    for sc in (sched, rsched):
        sc.levels[child] = sc.levels[sparent[child]]  # child at parent level
    codes = _codes(_errors(_both(lint_schedule(lap.sym, sched),
                                 ranalyze.lint_schedule(lap.rsym, rsched))))
    assert codes & {"parent-level", "ancestor-order", "levels-value"}
    assert "parent-level" in codes


def test_schedule_dropped_member_caught(lap):
    sched = copy.deepcopy(lap.sched)
    rsched = copy.deepcopy(lap.rsched)
    for li, lg in enumerate(sched.groups):
        for gi, bg in enumerate(lg):
            if len(bg.ids) >= 2:
                bg.ids = np.asarray(bg.ids)[1:]
                rbg = rsched.groups[li][gi]
                rbg.ids = np.asarray(rbg.ids)[1:]
                codes = _codes(_errors(_both(
                    lint_schedule(lap.sym, sched),
                    ranalyze.lint_schedule(lap.rsym, rsched))))
                assert "schedule-coverage" in codes
                return
    pytest.skip("no multi-member group")


def _device_mutation(lap, mutate):
    gp, rgp = copy.deepcopy(lap.gp), copy.deepcopy(lap.rgp)
    if not mutate(gp) or not mutate(rgp):
        pytest.skip("no group to mutate")
    return _both(lint_device_plan(lap.sym, lap.sched, gp),
                 ranalyze.lint_device_plan(lap.rsym, lap.rsched, rgp))


def test_device_plan_pack_duplicate_caught(lap):
    def mut(gp):
        gp.cells_concat[0] = gp.cells_concat[1]  # one cell packed twice
        return True

    assert "pack-coverage" in _codes(_errors(_device_mutation(lap, mut)))


def test_device_plan_segment_swap_caught(lap):
    # swap two pool indices across segment boundaries: still a permutation
    # (pool-coverage holds) but two updates assemble into the wrong cells —
    # exactly the write-write/wrong-cell race the segment-map check targets
    def mut(gp):
        for lg in gp.groups:
            for g in lg:
                n_in = np.asarray(g.src).shape[0]
                r = np.asarray(g.cells).shape[0]
                if n_in >= 2 and r >= 2 and int(g.hi[0]) < n_in:
                    g.src[0], g.src[-1] = int(g.src[-1]), int(g.src[0])
                    return True
        return False

    assert "segment-map" in _codes(_errors(_device_mutation(lap, mut)))


def test_device_plan_lost_update_caught(lap):
    def mut(gp):
        for lg in gp.groups:
            for g in lg:
                if np.asarray(g.src).shape[0] >= 2:
                    g.src[0] = int(g.src[1])  # one slot read twice, one lost
                    return True
        return False

    assert "pool-coverage" in _codes(_errors(_device_mutation(lap, mut)))


# ---------------------------------------------------------------------------
# pass 2: happens-before, static + trace
# ---------------------------------------------------------------------------
def test_plan_happens_before_clean(lap):
    assert plan_happens_before(lap.sym, lap.sched, lap.gp) == []


def test_pool_hb_violation_caught(lap):
    _dest, producer, _off = _pool_destinations(lap.sym, lap.sched, lap.gp)
    rproducer = r_pool_dest(lap.rsym, lap.rsched, lap.rgp)[1]
    np.testing.assert_array_equal(producer, rproducer)
    glevel = np.array([li for li, lg in enumerate(lap.gp.groups)
                       for _g in lg])
    gp, rgp = copy.deepcopy(lap.gp), copy.deepcopy(lap.rgp)
    gflat = [g for lg in gp.groups for g in lg]
    rflat = [g for lg in rgp.groups for g in lg]
    for k, li in enumerate(glevel):
        if np.asarray(gflat[k].src).size == 0:
            continue
        # point one read at a pool slot produced at this group's own level
        # or later — the assembly would read a not-yet-written entry
        late = np.flatnonzero(glevel[producer] >= li)
        if late.size:
            gflat[k].src[0] = rflat[k].src[0] = int(late[0])
            findings = _both(
                plan_happens_before(lap.sym, lap.sched, gp),
                ranalyze.plan_happens_before(lap.rsym, lap.rsched, rgp))
            assert "pool-hb" in _codes(_errors(findings))
            return
    pytest.skip("no constructible same-level read")


@pytest.mark.parametrize("events,kw,code", [
    ([("upload", 0), ("upload", 1), ("dispatch", 0), ("upload", 2),
      ("dispatch", 1), ("dispatch", 2)], {"n_levels": 3}, None),
    ([("upload", 0), ("dispatch", 0), ("dispatch", 1), ("upload", 1)],
     {"n_levels": 2}, "read-before-upload"),
    ([("upload", 0), ("upload", 1), ("dispatch", 1), ("dispatch", 0)], {},
     "level-order"),
    ([("upload", 0), ("dispatch", 0)], {"n_levels": 3}, "missing-level"),
    ([("upload", 0), ("dispatch", 0), ("donation_reuse", 0)], {},
     "donation-reuse"),
    ([("upload", 0), ("dispatch", 0), ("fallback:host", 0)], {"n_levels": 1},
     None),
], ids=["clean", "read-before-upload", "level-order", "missing-level",
        "donation-reuse", "fallback-event"])
def test_audit_trace(events, kw, code):
    findings = _both(audit_trace(events, **kw),
                     ranalyze.audit_trace(events, **kw))
    if code is None:
        assert findings == []
    else:
        assert code in _codes(_errors(findings))


def test_overflowed_trace_is_inconclusive_not_pass():
    # the dropped prefix could hide the upload: no PASS, no false FAIL
    ev = [("dispatch", 5), ("dispatch", 6)]
    findings = _both(audit_trace(ev, n_levels=7, overflowed=True),
                     ranalyze.audit_trace(ev, n_levels=7, overflowed=True))
    assert _errors(findings) == []
    assert any(f.severity == "inconclusive" and f.code == "trace-truncated"
               for f in findings)


def test_engine_ring_buffer_overflow_flag():
    eng = DeviceEngine(device="cpu", events_cap=4)
    cholesky(laplacian_2d(16), device_engine=eng)
    assert eng.events_overflowed and len(eng.events) == 4
    findings = audit_engine(eng)
    assert _errors(findings) == []
    assert any(f.code == "trace-truncated" for f in findings)
    eng.reset_events()
    assert not eng.events_overflowed and len(eng.events) == 0


def test_engine_donation_reuse_detected():
    # the port donates nothing, so a real trace never holds the event; one
    # seeded into the engine's log is still an error
    eng = DeviceEngine(device="cpu")
    cholesky(laplacian_2d(8), device_engine=eng)
    assert not [t for t, _ in eng.events if t == "donation_reuse"]
    eng._event("donation_reuse", 1)
    assert "donation-reuse" in _codes(_errors(audit_engine(eng)))


@pytest.mark.parametrize("staging", ["async", "sync"])
def test_traced_factorization_clean(staging):
    A = laplacian_2d(24)
    findings, eng, F = traced_factorization(A, device="cpu", staging=staging)
    assert _errors(findings) == [], "\n".join(map(str, findings))
    assert not eng.events_overflowed
    # the trace really covered the run: uploads + dispatches were recorded
    assert any(t == "dispatch" for t, _ in eng.events)
    assert F.stats["staging"] == staging


# ---------------------------------------------------------------------------
# pass 4: cache integrity
# ---------------------------------------------------------------------------
@pytest.fixture()
def saved_plan(tmp_path):
    A = canonical_csc(laplacian_2d(16))
    cache = PlanCache(tmp_path)
    plan = cache.get(A)
    return A, plan, tmp_path / f"plan_{plan.key}.pkl"


def test_check_plan_file_clean(saved_plan):
    A, plan, path = saved_plan
    findings, loaded = check_plan_file(path, expect_key=plan.key)
    assert _errors(findings) == [], "\n".join(map(str, findings))
    assert loaded is not None and loaded.key == plan.key


def test_tampered_blob_digest_mismatch(saved_plan):
    _A, _plan, path = saved_plan
    env = pickle.loads(path.read_bytes())
    blob = bytearray(env["blob"])
    blob[len(blob) // 2] ^= 0xFF  # flip one byte deep in the payload
    env["blob"] = bytes(blob)
    path.write_bytes(pickle.dumps(env))
    findings, loaded = check_plan_file(path)
    assert loaded is None
    assert "digest-mismatch" in _codes(_errors(findings))
    with pytest.raises(ValueError, match="corrupt"):
        CachedPlan.load(path)


def test_stale_format_version_rejected(saved_plan):
    _A, _plan, path = saved_plan
    path.write_bytes(pickle.dumps({"version": -1}))
    findings, loaded = check_plan_file(path)
    assert loaded is None
    assert "format-version" in _codes(_errors(findings))
    with pytest.raises(ValueError, match="format"):
        CachedPlan.load(path)


def test_reference_plan_file_rejected_unread(tmp_path):
    # a reference cache directory is not readable by the port: its files
    # carry no format name, so they are refused before the payload unpickles
    A = canonical_csc(laplacian_2d(10))
    path = ref.PlanCache(tmp_path).get(A).save(tmp_path)
    findings, loaded = check_plan_file(path)
    assert loaded is None
    assert _codes(_errors(findings)) == {"format-version"}
    cache = PlanCache(tmp_path)
    cache.get(A)
    assert cache.disk_rejects == 1 and cache.stats["misses"] == 1


def test_wrong_pattern_fingerprint_rejected(saved_plan):
    _A, plan, path = saved_plan
    other = pattern_fingerprint(laplacian_2d(24))
    findings, loaded = check_plan_file(path, expect_key=other)
    assert loaded is None
    assert "fingerprint-mismatch" in _codes(_errors(findings))
    with pytest.raises(ValueError, match="fingerprint"):
        CachedPlan.load(path, expect_key=other)


def test_truncated_file_unreadable(saved_plan):
    _A, _plan, path = saved_plan
    path.write_bytes(path.read_bytes()[: path.stat().st_size // 3])
    findings, loaded = check_plan_file(path)
    assert loaded is None
    assert _codes(_errors(findings)) & {"unreadable", "digest-mismatch",
                                        "malformed"}


def test_cache_get_rejects_and_rebuilds(saved_plan):
    # a corrupted disk file must not crash or poison the server: the cache
    # counts a reject, rebuilds, and overwrites with a good file
    A, plan, path = saved_plan
    path.write_bytes(b"not a plan at all")
    cache = PlanCache(path.parent)
    p2 = cache.get(A)
    assert cache.disk_rejects == 1
    assert cache.stats["misses"] == 1 and cache.stats["disk_hits"] == 0
    assert p2.key == plan.key
    findings, _ = check_plan_file(path)  # the rewrite is clean again
    assert _errors(findings) == []


def test_load_with_lint_gate(saved_plan, tmp_path):
    _A, plan, path = saved_plan
    loaded = CachedPlan.load(path, lint=True)  # clean plan passes the gate
    assert loaded.key == plan.key
    # a bit-intact file of a semantically wrong plan fails the gate
    bad = copy.deepcopy(plan)
    bad.fill_dst = bad.fill_dst.copy()
    bad.fill_dst[0] = bad.fill_dst[1]
    bad_path = bad.save(tmp_path / "bad.pkl")
    with pytest.raises(ValueError, match="fill-dup"):
        CachedPlan.load(bad_path, lint=True)
    findings, got = check_plan_file(bad_path)
    assert got is not None and "fill-dup" in _codes(_errors(findings))


# ---------------------------------------------------------------------------
# serving-layer hook: verify mode lints new plans and audits every trace
# ---------------------------------------------------------------------------
def test_server_verify_mode_clean():
    srv = CholeskyServer(device="cpu", verify=True)
    A = laplacian_2d(14)
    h = srv.factor(A)
    srv.factor(sp.csc_matrix(A + 0.5 * sp.eye(A.shape[0])))  # repeat pattern
    srv.factor_many([A, A])
    x = srv.solve(h, np.ones(A.shape[0]))
    assert np.linalg.norm(A @ np.asarray(x) - 1.0) < 1e-8
    assert not [f for f in srv.verify_findings if f.severity == "error"]
    assert "error" not in srv.report()["verify"]


def test_server_verify_raises_on_bad_trace():
    srv = CholeskyServer(device="cpu", verify=True)
    srv.factor(laplacian_2d(14))
    # seed a donation-reuse hazard into the engine's live trace: the next
    # request's audit must refuse to serve
    srv.engine._event("donation_reuse", 0)
    with pytest.raises(RuntimeError, match="donation-reuse"):
        srv._audit_factor(srv.factors[0])


def test_server_verify_refuses_a_bad_plan():
    # a new pattern whose plan fails the lint is never factored
    srv = CholeskyServer(device="cpu", verify=True)
    A = laplacian_2d(10)
    plan = srv.cache.get(A)
    plan.fill_dst[0] = plan.fill_dst[1]
    with pytest.raises(RuntimeError, match="fill-dup"):
        srv._verify_plan(plan)
    assert srv.stats.factorizations == 0


# ---------------------------------------------------------------------------
# property: random plans lint clean (the reference's hypothesis fuzz, on
# fixed seeds)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [2, 3, 5])
def test_random_spd_plan_lint_zero_errors(seed):
    sym, _ = symbolic_pipeline(random_spd(120, density=0.05, seed=seed))
    findings = lint_plan_stack(sym, buckets=("batch", "fused"))
    findings += plan_happens_before(
        sym, cached_schedule(sym, max_batch=256, bucket="fused"))
    assert _errors(findings) == [], "\n".join(map(str, findings))

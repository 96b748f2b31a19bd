"""The readers of the port's own spans and its index-byte count, on
hand-made Chrome traces: each returns its value; on a trace of a program
that opens none of those spans, and on a window without the count, each
returns None."""
import pytest

from cholbench import bench, readers, testing, trace
from cholbench.client import Window

NEW = ("index_ms.factor", "index_bytes_mb.factor", "chunk_ms.factor",
       "dispatch_ms.factor", "readback_copy_ms.factor",
       "readback_scatter_ms.factor", "plan_ms.factor", "guard_ms.factor",
       "permute_ms.solve", "substitute_ms.solve")


def _ev(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


#: one guarded factor request, as the port's spans nest in it (µs)
FACTOR = [
    _ev("cholbench.factor", 0, 100), _ev("serve.factor", 1, 98),
    _ev("serve.plan", 2, 2), _ev("guard.validate", 4, 3),
    _ev("factor.fill", 8, 5),
    _ev("factor.stage", 14, 26), _ev("stage.index", 15, 20),
    _ev("stage.chunk", 36, 3),
    _ev("factor.levels", 41, 29), _ev("stage.chunk", 45, 2),
    _ev("stage.chunk", 50, 4),
    _ev("factor.read_back", 72, 18), _ev("read_back.copy", 73, 12),
    _ev("read_back.scatter", 85, 4),
    _ev("guard.report", 91, 2),
    # after the traced request: read by nothing
    _ev("serve.release", 101, 1), _ev("stage.chunk", 120, 50),
]
#: two solve requests of a host right-hand side
SOLVE = [
    _ev("cholbench.solve", 0, 50), _ev("serve.solve", 1, 48),
    _ev("solve.prepare", 2, 1), _ev("solve.permute", 4, 2),
    _ev("solve.levels", 7, 33), _ev("solve.upload", 8, 1),
    _ev("solve.substitute", 10, 25), _ev("solve.download", 36, 3),
    _ev("solve.permute", 41, 3),
    _ev("cholbench.solve", 50, 50), _ev("serve.solve", 51, 48),
    _ev("solve.permute", 52, 1), _ev("solve.levels", 54, 30),
    _ev("solve.substitute", 56, 15), _ev("solve.permute", 90, 2),
]


def _ctx(kind, events, counters):
    win = Window(kind)
    n = sum(e["name"] == f"cholbench.{kind}" for e in events)
    win.reqs = [(0.0, 2e-4, 1, True)] + [(2e-4, 3e-4, 1, True)] * n
    win.t_start, win.t_end, win.traced = 0.0, 3e-4, n
    win.counters = counters
    return readers.Context(win, trace.Trace.from_events(events),
                           {"sym": None, "n": 4, "nrhs": 1}, 1.0)


def _read(name, ctx):
    return bench.load_file(bench.HERE / "metrics" / f"{name}.py").read(ctx)


def test_the_factor_readers():
    ctx = _ctx("factor", FACTOR, {"bytes_in": 4_000_000,
                                  "index_bytes_in": 3_000_000})
    assert _read("index_ms.factor", ctx) == pytest.approx(0.020)
    assert _read("chunk_ms.factor", ctx) == pytest.approx(0.009)
    assert _read("readback_copy_ms.factor", ctx) == pytest.approx(0.012)
    assert _read("readback_scatter_ms.factor", ctx) == pytest.approx(0.004)
    assert _read("plan_ms.factor", ctx) == pytest.approx(0.002)
    assert _read("guard_ms.factor", ctx) == pytest.approx(0.005)
    # 3 MB of index arrays over the window's 2 factorizations
    assert _read("index_bytes_mb.factor", ctx) == pytest.approx(1.5)
    # the old readers see the same work as before
    assert _read("stage_ms.factor", ctx) == pytest.approx(0.026)
    assert _read("readback_ms.factor", ctx) == pytest.approx(0.018)


def test_dispatch_subtracts_only_the_chunks_inside_the_levels():
    ctx = _ctx("factor", FACTOR, {})
    # 29 us of factor.levels less its chunks of 2 and 4 us; the chunk in
    # factor.stage and the one after the request stay out
    assert _read("dispatch_ms.factor", ctx) == pytest.approx(0.023)
    moved = [dict(e, ts=41 + 29 + 5) if e["ts"] == 50 else e
             for e in FACTOR]
    ctx = _ctx("factor", moved, {})
    assert _read("dispatch_ms.factor", ctx) == pytest.approx(0.027)


def test_the_solve_readers_average_over_requests():
    ctx = _ctx("solve", SOLVE, {})
    assert _read("permute_ms.solve", ctx) == pytest.approx((5 + 3) / 2e3)
    assert _read("substitute_ms.solve", ctx) == pytest.approx(
        (25 + 15) / 2e3)
    assert _read("index_ms.factor", ctx) is None


def test_guard_ms_is_none_without_a_guard_span():
    unguarded = [e for e in FACTOR if not e["name"].startswith("guard.")]
    ctx = _ctx("factor", unguarded, {})
    assert _read("guard_ms.factor", ctx) is None
    assert _read("plan_ms.factor", ctx) == pytest.approx(0.002)


def test_a_program_without_the_spans_and_count_reads_nothing():
    old = ("cholbench.", "factor.", "solve.prepare", "solve.levels")
    for kind, events in (("factor", FACTOR), ("solve", SOLVE)):
        kept = [e for e in events if e["name"].startswith(old)]
        ctx = _ctx(kind, kept, {"bytes_in": 4_000_000})
        assert {m: _read(m, ctx) for m in NEW} == dict.fromkeys(NEW)
    ctx = _ctx("factor", [e for e in FACTOR if e["name"].startswith(old)],
               {"bytes_in": 4_000_000})
    assert _read("stage_ms.factor", ctx) == pytest.approx(0.026)


def test_every_new_metric_is_declared_for_the_cells_that_read_it():
    spec = bench.load_spec()
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        assert (bench.HERE / "metrics" / f"{name}.py").exists()
        assert per_layer[name]["workloads"]
    # each lists only cells whose traffic's loop opens requests of its
    # kind, and guard_ms.factor every guarded factor cell
    assert testing.spec_problems(spec) == []

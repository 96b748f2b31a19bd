"""The port's spans (``repro_torch.core.spans``) and its index-byte count on
the CPU: a guarded factor, a solve and a two-matrix ``factor_many`` through
``CholeskyServer.handle`` under ``torch.profiler`` export every span of the
served path, each inside the parent it belongs to; with no profiler a span
is the shared null context; ``index_bytes_in`` counts the index plan's one
upload on the first request of a pattern, none on a repeat and nothing of
the values, and no rebuild."""
import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import counters, spans
from repro_torch.core.device_store import _KINDS
from repro_torch.launch.serve import CholeskyServer
from repro_torch.sparse import laplacian_3d

FACTOR_PHASES = ("factor.fill", "factor.stage", "factor.levels",
                 "factor.read_back")
SOLVE_PHASES = ("solve.prepare", "solve.levels")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small ops (as in
    ``test_torch_serve.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ranges(prof, tmp_path) -> list:
    """(name, t0, t1) of every ``record_function`` range in the profiler's
    Chrome export, by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = json.loads(path.read_text())["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in ev if e.get("ph") == "X"
           and e.get("cat") == "user_annotation"]
    return sorted(out, key=lambda r: r[1])


def _named(rs, name) -> list:
    return [r for r in rs if r[0] == name]


def _inside(r, outer) -> bool:
    return outer[1] <= r[1] and r[2] <= outer[2]


def _each_inside(rs, child, parent) -> bool:
    kids = _named(rs, child)
    parents = [r for r in rs if r[0] in parent.split("|")]
    return bool(kids) and all(any(_inside(k, p) for p in parents)
                              for k in kids)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One warm guarded factor, then a traced factor, a solve and a
    two-matrix factor_many of the same pattern."""
    A = laplacian_3d(5)
    n = A.shape[0]
    srv = CholeskyServer(device="cpu", guard="raise")
    srv.release(srv.handle("factor", A)["result"])
    A2 = sp.csc_matrix(A + 0.5 * sp.eye(n))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r = srv.handle("factor", A2)
        s = srv.handle("solve", r["result"], np.ones(n))
        m = srv.handle("factor_many", [A, A2])
    assert r["ok"] and s["ok"] and m["ok"]
    assert np.linalg.norm(A2 @ s["result"] - 1) <= 1e-10 * np.sqrt(n)
    return _ranges(prof, tmp_path_factory.mktemp("spans"))


FACTOR_REQ = "serve.factor|serve.factor_many"


@pytest.mark.parametrize("child, parent", [
    ("serve.plan", FACTOR_REQ),
    ("guard.validate", FACTOR_REQ),
    ("guard.report", FACTOR_REQ),
    ("stage.index", "factor.stage"),
    ("read_back.copy", "factor.read_back"),
    ("read_back.scatter", "factor.read_back"),
    ("solve.permute", "serve.solve"),
    ("solve.upload", "solve.levels"),
    ("solve.substitute", "solve.levels"),
    ("solve.download", "solve.levels"),
] + [(p, FACTOR_REQ) for p in FACTOR_PHASES]
  + [(p, "serve.solve") for p in SOLVE_PHASES])
def test_every_span_lies_in_its_parent(served, child, parent):
    assert _each_inside(served, child, parent)


def test_stage_chunk_is_level_0_in_stage_and_the_rest_in_levels(served):
    chunks = _named(served, "stage.chunk")
    stage = _named(served, "factor.stage")
    levels = _named(served, "factor.levels")
    # factor and factor_many: one chunk in each stage, the rest in levels
    assert len(stage) == len(levels) == 2
    for st, lv in zip(stage, levels):
        assert sum(_inside(c, st) for c in chunks) == 1
        assert sum(_inside(c, lv) for c in chunks) >= 1
    assert all(any(_inside(c, p) for p in stage + levels) for c in chunks)


def test_the_server_and_solve_spans_lie_outside_the_phases(served):
    phases = [r for r in served if r[0] in FACTOR_PHASES + SOLVE_PHASES]
    for name in ("serve.plan", "guard.validate", "guard.report",
                 "solve.permute"):
        for r in _named(served, name):
            assert not any(_inside(r, p) for p in phases), name
    # a host b is permuted in and out: two spans a request
    (req,) = _named(served, "serve.solve")
    assert sum(_inside(r, req) for r in _named(served, "solve.permute")) == 2


def test_factor_many_opens_the_same_spans(served):
    (req,) = _named(served, "serve.factor_many")
    inner = {r[0] for r in served if _inside(r, req)}
    assert {"serve.plan", "guard.validate", "guard.report", "stage.index",
            "stage.chunk", "read_back.copy", "read_back.scatter",
            *FACTOR_PHASES[1:], "factor.fill"} <= inner


def test_without_a_profiler_a_span_is_the_shared_null_context(monkeypatch):
    calls = []
    monkeypatch.setattr(spans, "record_function",
                        lambda name: calls.append(name))
    assert spans.span("a") is spans.span("b") is spans._NULL
    with spans.span("a"):
        pass
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        spans.span("c")
    assert calls == ["c"]


def test_index_bytes_count_the_index_plan_and_no_rebuild():
    """The first factor request of a pattern uploads its index plan; the
    repeat, new values of the same pattern, finds it resident on the
    server's engine and uploads only the values, with no rebuild."""
    A = laplacian_3d(5)
    srv = CholeskyServer(device="cpu", guard="off")
    grew = []
    for k, Ak in enumerate((A, sp.csc_matrix(A * 2.0))):
        st0 = dict(srv.engine.stats)
        before = counters.snapshot()
        h = srv.handle("factor", Ak)["result"]
        if k:
            assert counters.snapshot() == before
        grew.append({key: srv.engine.stats[key] - st0[key] for key in st0})
        gp = srv.factors[h].dstore.plan
        srv.release(h)
    assert srv.stats.repeat_rebuilds == 0
    want = sum(getattr(g, k).nbytes for lvl in gp.groups for g in lvl
               for k in _KINDS)
    assert [g["index_bytes_in"] for g in grew] == [want, 0] and want > 0
    # what is left of bytes_in is the values: 8 bytes a packed cell
    for g in grew:
        assert g["bytes_in"] - g["index_bytes_in"] == 8 * gp.packed_total
    # two entries a plan: the group index arrays and the read-back order
    assert {k: srv.report()["index_cache"][k] for k in ("hits", "misses")} \
        == {"hits": 2, "misses": 2}

"""The port's solver server (``repro_torch.launch.serve``) on the CPU: the
six tests of ``tests/test_serve.py`` — plan-cache reuse, resident factors
and solves, the synthetic stream driver — plus the CLI across two
processes' worth of servers on one cache directory, and the same stream
through the reference's server and the port's.  Equal across the two:
request kinds, rejections, degraded counters, cache stats, rebuilds,
factorizations and solves; every solve within 1e-10 * max|x|.  The engine's
``device_calls`` follow each package's own bucket family, so they are held
to the port's schedule."""
import ast
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.launch import serve as rserve  # noqa: E402

from repro_torch.core import cached_schedule, counters  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serve import (  # noqa: E402
    CholeskyServer,
    _grid_laplacian,
    run_stream,
    synthetic_stream,
)


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


def _cpu_server(**kw):
    return CholeskyServer(device="cpu", **kw)


def test_server_factor_solve_roundtrip():
    srv = _cpu_server()
    A = _grid_laplacian(10, 1.5)
    h = srv.factor(A)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    x = srv.solve(h, b)
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-10
    assert srv.stats.factorizations == 1
    assert srv.stats.solves == 1
    srv.release(h)
    assert h not in srv.factors


def test_server_repeat_pattern_zero_rebuilds():
    """Repeat-pattern requests through the server must never rebuild any
    symbolic artifact (the server enforces it too, via repeat_rebuilds)."""
    srv = _cpu_server()
    srv.factor(_grid_laplacian(9, 1.0))   # miss: analyzed + warmed
    before = counters.snapshot()
    h = srv.factor(_grid_laplacian(9, 2.0))   # repeat pattern, new values
    srv.solve(h, np.ones(81))
    assert counters.delta(before) == {}
    assert srv.stats.repeat_rebuilds == 0
    assert srv.cache.stats == {"hits": 1, "misses": 1, "disk_hits": 0,
                               "evictions": 0}


def test_server_factor_many_counts_matrices():
    srv = _cpu_server()
    As = [_grid_laplacian(8, 1.0 + 0.5 * i) for i in range(3)]
    h = srv.factor_many(As)
    B = np.random.default_rng(1).standard_normal((3, 64, 2))
    X = srv.solve(h, B)
    for A, x, b in zip(As, X, B):
        assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-10
    assert srv.stats.factorizations == 3
    assert srv.stats.factor_requests == 1
    assert srv.stats.solves == 6  # 3 matrices x 2 RHS columns


def test_server_disk_cache_across_instances(tmp_path):
    """A fresh server on the same cache_dir serves its first request from
    the persisted plan: a disk hit, zero analysis builds."""
    A = _grid_laplacian(9, 1.0)
    srv1 = _cpu_server(cache_dir=tmp_path)
    srv1.factor(A)

    srv2 = _cpu_server(cache_dir=tmp_path)  # "restarted server"
    before = counters.snapshot()
    h = srv2.factor(_grid_laplacian(9, 3.0))
    assert counters.delta(before) == {}
    assert srv2.cache.stats["disk_hits"] == 1
    assert srv2.stats.repeat_rebuilds == 0
    b = np.ones(81)
    A2 = _grid_laplacian(9, 3.0)
    assert np.linalg.norm(A2 @ srv2.solve(h, b) - b) < 1e-9


def test_synthetic_stream_shape():
    reqs = synthetic_stream(requests=20, patterns=3, grid=8, many=4, seed=0)
    assert len(reqs) == 20
    # every pattern's first appearance is a plain factor (cache miss)
    first = {}
    for kind, pat, _m in reqs:
        first.setdefault(pat, kind)
    assert set(first) == {0, 1, 2}
    assert all(k == "factor" for k in first.values())
    assert reqs == rserve.synthetic_stream(requests=20, patterns=3, grid=8,
                                           many=4, seed=0)


def test_run_stream_end_to_end():
    srv = _cpu_server()
    reqs = synthetic_stream(requests=10, patterns=2, grid=8, many=2, seed=1)
    rep = run_stream(srv, reqs, grid=8, seed=1)
    assert rep["cache"]["misses"] == 2                # one per pattern
    assert rep["repeat_rebuilds"] == 0                # the service guarantee
    assert rep["factorizations"] >= 2
    assert rep["factorizations_per_s"] > 0
    assert rep["max_solve_resid"] < 1e-9
    assert sum(rep["requests"].values()) == len(reqs)
    assert rep["fallbacks"] == {"plain": 0, "host": 0, "failed": 0}


def _recorded(srv):
    """Record every successful solve's result as ``srv.handle`` returns
    it."""
    out = []
    handle = srv.handle

    def record(kind, *args, **kw):
        res = handle(kind, *args, **kw)
        if kind == "solve" and res["ok"]:
            out.append(np.asarray(res["result"]))
        return res

    srv.handle = record
    return out


def _expected_device_calls(srv, reqs, grid):
    """The port's engine calls for a clean stream, from its own "fused"
    schedule: one per group per factorization (a batch is one set), and
    per solve one per level and direction, plus one inversion per group at
    a factor's first solve."""
    scheds = {}
    for pat in {p for _k, p, _m in reqs}:
        plan = srv.cache.get(_grid_laplacian(grid + pat, 1.0))
        scheds[pat] = cached_schedule(plan.sym, bucket="fused")
    calls, solved = 0, {}
    for kind, pat, _m in reqs:
        sched = scheds[pat]
        nb = sum(len(lg) for lg in sched.groups)
        if kind != "solve":
            calls += nb
            solved[pat] = False
        elif pat in solved:
            calls += 2 * sched.n_levels + (0 if solved[pat] else nb)
            solved[pat] = True
    return calls


def test_stream_parity_with_reference():
    kw = dict(requests=10, patterns=2, grid=8, many=2, seed=1)
    srv = _cpu_server()
    xs = _recorded(srv)
    reqs = synthetic_stream(**kw)
    rep = run_stream(srv, reqs, grid=8, seed=1)
    rsrv = rserve.CholeskyServer(backend="xla")
    rxs = _recorded(rsrv)
    rrep = rserve.run_stream(rsrv, rserve.synthetic_stream(**kw), grid=8,
                             seed=1)
    for key in ("requests", "rejected", "degraded", "cache",
                "repeat_rebuilds", "factorizations", "solves", "patterns",
                "guard"):
        assert rep[key] == rrep[key], key
    assert len(xs) == len(rxs) == rep["requests"]["solve"]
    for x, rx in zip(xs, rxs):
        assert x.shape == rx.shape
        assert np.max(np.abs(x - rx)) <= 1e-10 * np.max(np.abs(rx))
    stats = rep["engine"]
    assert stats["device_calls"] == _expected_device_calls(srv, reqs, 8)
    assert stats["transfers_out"] >= rep["factorizations"] // 2


def test_cli_second_process_serves_from_disk(tmp_path, monkeypatch, capsys):
    """The CLI, run twice on one cache directory: the second server's plan
    cache has only disk hits, no misses."""
    argv = ["serve", "--device", "cpu", "--requests", "6", "--patterns",
            "2", "--grid", "8", "--many", "2", "--nrhs", "2",
            "--cache-dir", str(tmp_path)]
    caches = []
    for _ in range(2):
        monkeypatch.setattr(sys, "argv", argv)
        serve.main()
        line = next(ln for ln in capsys.readouterr().out.splitlines()
                    if "plan cache:" in ln)
        caches.append(ast.literal_eval(
            line.split("plan cache:")[1].split("repeat_rebuilds")[0].strip()))
    assert caches[0]["misses"] == 2 and caches[0]["disk_hits"] == 0
    assert caches[1]["misses"] == 0 and caches[1]["disk_hits"] == 2

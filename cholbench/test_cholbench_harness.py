"""The harness's loops, readers and last line, driven at a small size
against the port's server on the CPU (the kernels' plain versions), and
its trace arithmetic on a hand-made trace.  ``run.py`` itself needs a
card: without one it fails and prints no result."""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from cholbench import bench, readers, trace
from cholbench.client import Window
from cholbench.testing import small_cell

SPEC = bench.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
ENV = dict(os.environ, PYTHONPATH=str(bench.ROOT / "src"))


def _run(name, trace_on, seed=2 ** 31 + 99, spec=SPEC, root=bench.ROOT):
    cell = small_cell(spec, name, root)
    t = time.perf_counter()
    return cell, bench.run(cell, seed=seed, seconds=0.3, trace=trace_on,
                           t_start=t, clock=time.perf_counter, device="cpu")


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace_on", [False, True])
def test_a_run_on_the_cpu_gives_a_whole_line(name, trace_on):
    _check_whole_line(*_run(name, trace_on), trace_on)


def _check_whole_line(cell, result, trace_on):
    line, checks = result
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    assert checks == [f"check {k} {c['value']!r} limit {c['limit']!r}"
                      for k, c in line["checks"].items()]
    json.loads(json.dumps(line))
    want = {m["name"]: m["unit"] for m in
            cell.metrics("per_layer" if trace_on else "end_to_end")}
    got = {k: v["unit"] for k, v in line["metrics"].items()}
    if trace_on:
        # the CPU has no device trace: the device readers find nothing
        device = {m["name"] for m in cell.spec["per_layer"]
                  if m["source"] == "device_trace"}
        assert got == {k: u for k, u in want.items() if k not in device}
        assert "breakdown" in line and line["device"]["window_s"] > 0
    else:
        assert got == want
        assert all(v["value"] > 0 for v in line["metrics"].values())


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for name in CELLS:
        cell = small_cell(SPEC, name)
        e2e = {m["name"] for m in cell.metrics("end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.metrics("per_layer")
        for m in cell.metrics("per_layer"):
            assert m["moves"] in e2e
            assert (bench.HERE / "metrics" / f"{m['name']}.py").exists()


def test_run_py_without_a_card_fails_and_prints_nothing():
    p = subprocess.run(
        [sys.executable, str(bench.HERE / "run.py"), "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=ENV, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_nothing_the_run_loads_is_jax_or_the_reference_package():
    code = (
        "import sys, glob, importlib.util\n"
        "sys.path[:0] = ['.', 'src']\n"
        "from cholbench import bench, calibrate, reference, readers\n"
        "import repro_torch.launch.serve\n"
        "for f in glob.glob('cholbench/*/*.py'):\n"
        "    if not f.endswith('__init__.py'):\n"
        "        bench.load_file(bench.Path(f))\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=bench.ROOT, env=ENV, timeout=300)
    assert p.returncode == 0, p.stderr
    top = set(p.stdout.split())
    assert "repro_torch" in top and "cholbench" in top
    assert not top & set(bench.FORBIDDEN)


def test_forbidden_modules_compares_whole_top_level_names():
    names = ["repro_torch.core", "reprocess", "jaxtyping", "numpy"]
    assert bench.forbidden_modules(names) == []
    assert bench.forbidden_modules(names + ["repro.core", "jax.numpy"]) \
        == ["jax", "repro"]


# ---------------------------------------------------------------------------
# trace arithmetic on a hand-made Chrome trace
# ---------------------------------------------------------------------------
def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace():
    ev = [
        _ev("user_annotation", "cholbench.factor", 0, 100),
        _ev("user_annotation", "factor.fill", 5, 10),
        _ev("user_annotation", "factor.stage", 20, 20),
        _ev("user_annotation", "factor.levels", 45, 30),
        _ev("user_annotation", "factor.read_back", 80, 10),
        _ev("cuda_runtime", "cudaMemcpyAsync", 25, 1, 1),
        _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 26, 10, 1),
        _ev("cuda_runtime", "cudaLaunchKernel", 50, 1, 2),
        _ev("kernel", "void (anonymous namespace)::panel_kernel<false>"
            "(double*, int const*)", 51, 8, 2),
        _ev("cuda_runtime", "cudaLaunchKernel", 52, 1, 3),
        _ev("kernel", "(anonymous namespace)::syrk_kernel(double const*)",
            55, 12, 3),
        _ev("cuda_runtime", "cudaMemcpyAsync", 82, 1, 4),
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 83, 5, 4),
    ]
    return trace.Trace.from_events(ev)


def test_trace_union_gaps_and_attribution():
    tr = _trace()
    assert trace.union_length(tr.device, 0, 100) == 10 + 16 + 5
    assert trace.gaps(tr.device, 0, 100)[0] == (0, 26)
    levels = tr.named("factor.levels")
    assert [trace.function_name(op.name) for op in tr.issued_in(levels)] \
        == ["panel_kernel", "syrk_kernel"]
    assert tr.innermost(60) == "factor.levels"
    assert tr.innermost(3) == "cholbench.factor"
    bd = tr.breakdown(0, 100)
    assert bd["device_ops"][0] == ["(anonymous namespace)::syrk_kernel",
                                   12e-6]
    assert bd["idle_gaps"][:2] == [["factor.fill", 26e-6],
                                   ["factor.levels", 16e-6]]


def test_readers_on_a_hand_made_trace():
    class Sym:  # one supernode of width 2 and 4 rows
        super_ptr = [0, 2]
        rows = [[0, 1, 2, 3]]

    win = Window("factor")
    win.reqs = [(0.0, 2e-4, 1, True), (2e-4, 3e-4, 1, True)]
    win.t_start, win.t_end, win.traced = 0.0, 3e-4, 1
    win.counters = {"bytes_in": 4_000_000}
    ctx = readers.Context(win, _trace(), {"sym": Sym, "n": 4, "nrhs": 0},
                          12.5)

    def read(name):
        return bench.load_file(bench.HERE / "metrics" / f"{name}.py").read(ctx)

    assert read("factor_s") == pytest.approx(1.5e-4)
    assert read("setup_s") == 12.5
    assert read("server_ms.factor") == pytest.approx((100 - 70) / 1e3)
    assert read("fill_ms.factor") == pytest.approx(0.010)
    assert read("stage_ms.factor") == pytest.approx(0.020)
    assert read("readback_ms.factor") == pytest.approx(0.010)
    assert read("bytes_in_mb.factor") == pytest.approx(2.0)
    assert read("levels_device_ms.factor") == pytest.approx(0.016)
    # 31 us busy over the one traced factorization, 200 us the untraced one
    assert read("device_idle.factor") == pytest.approx(100 * (1 - 31 / 200))
    flops = 4 ** 2 + 3 ** 2
    least = max(flops / 67e12, 8 * (2 * 7 + 3) / 3.35e12)
    assert read("fused_roofline.factor") == pytest.approx(
        100 * least / 20e-6)
    assert read("factor_peak_share.factor") == pytest.approx(
        100 * flops / (2e-4 * 67e12))
    assert read("solve_s") is None and read("solve_device_ms.solve") is None


REFACTOR = [n for n in CELLS
            if bench.Cell(SPEC, n).traffic["loop"] == "refactor"]


@pytest.mark.parametrize("name", REFACTOR)
def test_every_refactor_request_sends_values_no_earlier_one_sent(name):
    cell = small_cell(SPEC, name)
    A = cell.generator.make(**cell.cfg["params"])
    st = cell.loop.prepare(A, cell.cfg, cell.traffic, 2 ** 31 + 3)
    gen = st.requests()
    sent = []
    for i in range(3 * len(st.sets) + 1):
        kind, (M,), count = next(gen)
        assert kind == "factor" and count == 1
        assert np.array_equal(M.indices, A.indices)
        assert np.array_equal(M.indptr, A.indptr)
        # what the check makes again from the seed is what was sent
        assert np.array_equal(M.data, st.values(i)[2])
        sent.append(M.data.copy())
    assert len({d.tobytes() for d in sent}) == len(sent)
    # only the diagonal moves between requests of one pooled set
    off = np.ones(A.nnz, bool)
    off[st.vs.diag] = False
    j = st.set_of(0)
    same = [d for i, d in enumerate(sent) if st.set_of(i) == j]
    assert all(np.array_equal(d[off], same[0][off]) for d in same)


def test_a_pool_of_one_value_set_is_refused():
    cell = bench.Cell(SPEC, REFACTOR[0], params={"nx": 4})
    A = cell.generator.make(**cell.cfg["params"])
    with pytest.raises(ValueError, match="at least 2"):
        cell.loop.prepare(A, cell.cfg, dict(cell.traffic, value_sets=1), 1)


def test_the_idle_share_reads_the_untraced_requests_time():
    win = Window("solve")
    # two untraced requests of 100 us, then one traced, stretched to 300 us
    # by the profiler; the device ran 31 us of it
    win.reqs = [(0.0, 1e-4, 1, True), (1e-4, 2e-4, 1, True),
                (2e-4, 5e-4, 1, True)]
    win.t_start, win.t_end, win.traced = 0.0, 5e-4, 1
    tr = trace.Trace.from_events([
        _ev("user_annotation", "cholbench.solve", 0, 300),
        _ev("cuda_runtime", "cudaLaunchKernel", 40, 1, 1),
        _ev("kernel", "gemv", 50, 10, 1),
        _ev("cuda_runtime", "cudaLaunchKernel", 90, 1, 2),
        _ev("kernel", "gemv", 100, 21, 2)])
    ctx = readers.Context(win, tr, {"sym": None, "n": 4, "nrhs": 1}, 1.0)
    assert readers.idle_pct(ctx, "solve") == pytest.approx(69.0)
    assert readers.idle_pct(ctx, "factor") is None


def test_the_profiler_runs_only_after_the_untraced_requests():
    from cholbench.client import run_window

    log = []

    class Engine:
        stats = {"bytes_in": 0}

    class Server:
        engine = Engine()

        def handle(self, kind, *args):
            log.append("request")
            time.sleep(0.01)
            return {"ok": True, "result": None}

    class FakeTracer:
        def start(self):
            log.append("start")

        def stop(self):
            log.append("stop")

    reqs = iter(lambda: ("solve", (), 1), None)
    win = run_window(Server(), "solve", reqs, 0.05, FakeTracer(), 3,
                     lambda i, res: None)
    assert log[-5:] == ["start", "request", "request", "request", "stop"]
    assert log.count("start") == 1 and len(win.reqs) == log.count("request")
    assert win.traced == 3 and len(win.untraced()) == len(win.reqs) - 3
    assert win.traced_reqs() == win.reqs[-3:]
    log.clear()
    win = run_window(Server(), "solve", reqs, 0.05, None, 3,
                     lambda i, res: None)
    assert "start" not in log and win.traced == 0
    assert win.untraced() == win.reqs

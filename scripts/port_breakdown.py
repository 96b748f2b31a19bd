#!/usr/bin/env python3
"""Where one factorization and solve of the PyTorch/CUDA port spend their
time on the card:

    python3 scripts/port_breakdown.py [--guard G] [--many M] [matrix ...]
                                            (default lap3d_40 kkt_256)

For each matrix (names from ``MATRIX_SUITE``): the host symbolic phase, one
first factorization (builds the schedule and device plan, cached on the
symbolic factor), a warm factorization and warm device solves (1 and 64
right-hand sides) with the bytes it moved, then a ``torch.profiler`` trace of one more
factorization and its first solve, which reads

* the phase ranges that ``numeric._factorize_levels_device`` and
  ``device_store.device_solve`` open (``factor.fill``, ``factor.stage``,
  ``factor.levels``, ``factor.read_back``, ``solve.prepare``,
  ``solve.levels``): each range's host wall time, and the device time of
  the kernels and copies it issued.  The ranges do not synchronise the
  device, so ``factor.read_back`` also waits for the levels' device work;
* device time by kernel and copy name.

The device's idle share, and the finer spans inside these ranges, are read
by the benchmark's traced run: ``python3 cholbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace 1``.

``--guard raise`` (or ``perturb``) adds a trace of one factorization with
that guard (the guarded kernel) beside the unguarded one.  ``--many M``
adds, through one ``PlanCache`` plan, a trace of one warm ``cholesky(A,
plan=)`` and one warm ``cholesky_many`` of M shifted copies ``A + s I``
(the same ranges, ``factor.fill`` being the plan's vectorized fill), with
their wall times.

Prints one JSON object per matrix, then the card's name and power limit.
Needs a CUDA card; the kernels are built at first use.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import (  # noqa: E402
    DeviceEngine,
    PlanCache,
    cholesky,
    cholesky_many,
    symbolic_pipeline,
)
from repro_torch.sparse import make_suite_matrix  # noqa: E402

PHASES = ("factor.fill", "factor.stage", "factor.levels", "factor.read_back",
          "solve.prepare", "solve.levels")


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _device_us(ev) -> float:
    return getattr(ev, "device_time_total",
                   getattr(ev, "cuda_time_total", 0.0))


def profiled(A, sym, Aperm, run=None, phases=PHASES) -> dict:
    """Phase ranges, and device time by kernel (and copy) name, over one
    factorization and its first solve (or over ``run()``, with the ranges
    ``phases``).  Operator rows (``aten::...``) are left out of the kernel
    list: their device time is their kernels' again."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # the tracer's own start-up, not timed
        torch.ones(1, device="cuda").sum().item()
    b = np.random.default_rng(0).standard_normal(A.shape[0])

    def factor_and_solve():
        cholesky(A, sym=sym, Aperm=Aperm).solve(b, backend="device")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        (run or factor_and_solve)()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    found, rows = {}, []
    for ev in prof.key_averages():
        if ev.key in phases:
            ph = found.setdefault(ev.key, {"host_ms": 0.0, "device_ms": 0.0})
            ph["host_ms"] += ev.cpu_time_total / 1e3
            ph["device_ms"] += _device_us(ev) / 1e3
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0 and not ev.key.startswith("aten::") \
                and ev.key != "Activity Buffer Request":
            rows.append((ev.key, dev_us / 1e3, ev.count))
    missing = [k for k in phases if k not in found]
    if missing:
        raise AssertionError(f"profiler trace lacks the ranges {missing}")
    rows.sort(key=lambda r: -r[1])
    return {"wall_s": wall, "phases": {k: found[k] for k in phases},
            "top": [{"name": k[:80], "ms": ms, "count": c}
                    for k, ms, c in rows[:15]]}


FACTOR = PHASES[:4]


def guarded(A, sym, Aperm, guard: str) -> dict:
    """A warm factorization with ``guard`` and a trace of one more."""
    cholesky(A, sym=sym, Aperm=Aperm, guard=guard)
    _, warm = _timed(lambda: cholesky(A, sym=sym, Aperm=Aperm, guard=guard))
    prof = profiled(A, sym, Aperm, run=lambda: cholesky(
        A, sym=sym, Aperm=Aperm, guard=guard), phases=FACTOR)
    return {"guard": guard, "factor_warm_s": warm, "profile": prof}


def many(A, M: int) -> dict:
    """Warm wall times and traces of one ``cholesky(A_i, plan=)`` and of one
    ``cholesky_many`` of M shifted copies, through one plan."""
    import scipy.sparse as sp

    plan = PlanCache().get(A)
    n = A.shape[0]
    As = [sp.csc_matrix(A + s * sp.eye(n)) for s in np.linspace(0, 2, M)]
    eng = DeviceEngine()
    single = lambda: cholesky(As[0], plan=plan, device_engine=eng)  # noqa
    batch = lambda: cholesky_many(As, plan=plan, device_engine=eng)  # noqa
    out = {"M": M}
    for tag, fn in (("single", single), ("many", batch)):
        fn()
        _, out[f"{tag}_warm_s"] = _timed(fn)
        out[f"{tag}_profile"] = profiled(A, None, None, run=fn,
                                         phases=FACTOR)
    return out


def main(argv) -> None:
    guard, M, names = None, 0, []
    it = iter(argv)
    for a in it:
        if a == "--guard":
            guard = next(it)
        elif a == "--many":
            M = int(next(it))
        else:
            names.append(a)
    names = names or ["lap3d_40", "kkt_256"]
    if not torch.cuda.is_available():
        raise SystemExit("port_breakdown: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    for name in names:
        A = make_suite_matrix(name)
        (sym, Aperm), t_sym = _timed(lambda: symbolic_pipeline(A))
        rec = {"matrix": name, "n": A.shape[0], "symbolic_s": t_sym}
        _, rec["factor_first_s"] = _timed(
            lambda: cholesky(A, sym=sym, Aperm=Aperm))
        eng = DeviceEngine()
        F, rec["factor_warm_s"] = _timed(
            lambda: cholesky(A, sym=sym, Aperm=Aperm, device_engine=eng))
        rec["bytes_in"] = eng.stats["bytes_in"]
        rec["bytes_out"] = eng.stats["bytes_out"]
        rng = np.random.default_rng(0)
        for k in (1, 64):
            b = rng.standard_normal((A.shape[0], k))
            F.solve(b, backend="device")
            _, rec[f"solve{k}_warm_s"] = _timed(
                lambda: F.solve(b, backend="device"))
        del F
        rec["profile"] = profiled(A, sym, Aperm)
        if guard:
            rec["guarded"] = guarded(A, sym, Aperm, guard)
        if M:
            rec["many"] = many(A, M)
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    print(smi)


if __name__ == "__main__":
    main(sys.argv[1:])

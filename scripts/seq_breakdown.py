#!/usr/bin/env python3
"""Where the paper's sequential RL/RLB paths spend their time on the card:

    python3 scripts/seq_breakdown.py [matrix]        (default lap3d_40)

For one matrix (a name from ``MATRIX_SUITE``) it runs, on one symbolic
analysis, the host-only baseline and the offloaded runs through
``factorize_rl`` / ``factorize_rlb`` with the engines ``cholesky`` would
build:

    rl_host_only            HostEngine only (numpy/scipy: the paper's CPU run)
    rl_gpu_only_unfused     every supernode on the card: potrf, trsm_rlt,
                            syrk_ln
    rl_gpu_only_fused       every supernode on the card: fused_factor_syrk
    rl_paper_threshold      rows*w >= 600,000 on the card (fused), the rest
                            in numpy
    rlb_host_only           HostEngine only
    rlb_paper_threshold     rows*w >= 750,000 on the card (fused)
    rlb_gpu_only_unfused    every supernode on the card: potrf, trsm_rlt,
                            syrk_ln per block, gemm_nt per block pair

Each run's wall time is split by engine operation (``stage``, ``factor``,
``read_panel``, ``syrk_tail``, ``syrk_block``, ``gemm_block``, ``fetch``,
``gather``, ``release``; host and device engine apart), the panel fill and
the host scatter, with the card synchronised after every device operation
(the path synchronises at each read-back anyway).  ``rl_gpu_only_unfused``
is then run once more under ``torch.profiler``: device time by kernel and
the device's busy share of the wall time.  Finally every run is repeated
in a child process with one BLAS thread (``OPENBLAS_NUM_THREADS``,
``OMP_NUM_THREADS``, ``MKL_NUM_THREADS`` = 1; its runs are suffixed
``_one_blas_thread``), since numpy's threaded BLAS on many small
supernodes can be slower than one thread, and the host engine and the
host scatter are numpy.

Prints one JSON line per run, then the card's name and power limit.  Needs
a CUDA card; the kernels are built at first use.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import (  # noqa: E402
    DeviceEngine,
    HostEngine,
    OffloadPolicy,
    PanelStore,
    factorize_rl,
    factorize_rlb,
    symbolic_pipeline,
)
from repro_torch.core import numeric  # noqa: E402
from repro_torch.sparse import make_suite_matrix  # noqa: E402

OPS = ("stage", "factor", "read_panel", "syrk_tail", "syrk_block",
       "gemm_block", "fetch", "gather", "release")

RUNS = {  # name: (method, threshold or None for host only, fused)
    "rl_host_only": ("rl", None, True),
    "rl_gpu_only_unfused": ("rl", 0, False),
    "rl_gpu_only_fused": ("rl", 0, True),
    "rl_paper_threshold": ("rl", 600_000, True),
    "rlb_host_only": ("rlb", None, True),
    "rlb_paper_threshold": ("rlb", 750_000, True),
    "rlb_gpu_only_unfused": ("rlb", 0, False),
}


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class _Clock:
    """Seconds and calls per label, from wrapped callables."""

    def __init__(self):
        self.s = defaultdict(float)
        self.n = defaultdict(int)

    def wrap(self, label: str, fn, sync: bool):
        def timed(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                _sync()
            self.s[label] += time.perf_counter() - t0
            self.n[label] += 1
            return out
        return timed


def run(name: str, sym, Aperm) -> dict:
    method, thr, fused = RUNS[name]
    clock = _Clock()
    host = HostEngine()
    dev = None if thr is None else DeviceEngine(fused=fused)
    for eng, tag, sync in ((host, "host", False), (dev, "device", True)):
        if eng is None:
            continue
        for op in OPS:
            setattr(eng, op, clock.wrap(f"{tag}.{op}", getattr(eng, op), sync))
    fill, scatter = numeric.init_panel_store, PanelStore.scatter
    numeric.init_panel_store = clock.wrap("fill", fill, False)
    PanelStore.scatter = clock.wrap("scatter", scatter, False)
    try:
        fact = factorize_rl if method == "rl" else factorize_rlb
        kw = {} if dev is None else {"device_engine": dev,
                                     "policy": OffloadPolicy(thr)}
        _sync()
        t0 = time.perf_counter()
        F = fact(sym, Aperm, engine=host, **kw)
        _sync()
        wall = time.perf_counter() - t0
    finally:
        numeric.init_panel_store, PanelStore.scatter = fill, scatter
    parts = {k: {"s": v, "calls": clock.n[k]}
             for k, v in sorted(clock.s.items(), key=lambda kv: -kv[1])}
    rec = {"run": name, "method": method, "threshold": thr, "fused": fused,
           "wall_s": wall, "parts": parts,
           "other_s": wall - sum(clock.s.values()),
           "supernodes_on_device": F.stats["supernodes_on_device"],
           "supernodes_total": F.stats["supernodes_total"]}
    if dev is not None:
        rec["stats"] = dict(dev.stats)
    return rec


def profiled(sym, Aperm) -> dict:
    """Device time by kernel over one ``rl_gpu_only_unfused`` run, and the
    device's busy share of its wall time (the tracer adds host time)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # the tracer's own start-up, not timed
        torch.ones(1, device="cuda").sum().item()
    _sync()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        factorize_rl(sym, Aperm, device_engine=DeviceEngine(fused=False),
                     policy=OffloadPolicy(0))
        _sync()
    wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0 and not ev.key.startswith("aten::") \
                and ev.key != "Activity Buffer Request":
            rows.append((ev.key, us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e3
    return {"run": "rl_gpu_only_unfused (profiled)", "wall_s": wall,
            "device_busy_s": busy, "device_busy_share": busy / wall,
            "top": [{"name": k[:80], "ms": ms, "count": c}
                    for k, ms, c in rows[:15]]}


def main(name: str, child: bool = False) -> None:
    """All runs on one matrix; the parent also profiles and then starts the
    one-BLAS-thread child (``child=True``, which suffixes its run names)."""
    if not torch.cuda.is_available():
        raise SystemExit("seq_breakdown: needs a CUDA card")
    A = make_suite_matrix(name)
    t0 = time.perf_counter()
    sym, Aperm = symbolic_pipeline(A)
    suffix = "_one_blas_thread" if child else ""
    print(json.dumps({"matrix": name, "n": A.shape[0],
                      "supernodes": sym.nsuper, "blas": suffix or "default",
                      "symbolic_s": time.perf_counter() - t0}), flush=True)
    run("rl_gpu_only_fused", sym, Aperm)  # warm-up: kernel builds, allocator
    for r in RUNS:
        rec = run(r, sym, Aperm)
        rec["run"] += suffix
        print(json.dumps(rec), flush=True)
    if child:
        return
    print(json.dumps(profiled(sym, Aperm)), flush=True)
    env = dict(os.environ, OPENBLAS_NUM_THREADS="1", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    out = subprocess.run([sys.executable, __file__, "--one-thread", name],
                         env=env, capture_output=True, text=True, timeout=1800)
    if out.returncode != 0:
        raise SystemExit(f"one-thread child failed:\n{out.stderr}")
    print(out.stdout.strip(), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    args = sys.argv[1:]
    child = args[:1] == ["--one-thread"]
    args = args[1:] if child else args
    main(args[0] if args else "lap3d_40", child=child)

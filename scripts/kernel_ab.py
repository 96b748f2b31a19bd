#!/usr/bin/env python3
"""Times the fused kernel and ``gemm_nt`` of one checkout of the repo on the
card, so two versions can be compared in one run on one card:

    python3 scripts/kernel_ab.py TREE      (TREE: a checkout's root)

Run it for the two checkouts in turns (A, B, B, A).  It imports the port
from ``TREE/src`` (building its kernels into ``TREE/build/kernels``) and
prints one JSON line: CUDA-event mean milliseconds of

* ``fused_factor_syrk`` on the group buffers of ``lap3d_40``'s fused
  schedule that ``chip_smoke.py`` checks (the largest group, which is the
  Bp = 1, 2048 x 2048 lane; the most tail-heavy group; the group with the
  most pad lanes, garbage in its pad cells) and on the two one-panel
  buffers the sequential path passes (the widest supernode, the largest
  tail);
* the guarded kernel on the largest group (thr = 0);
* ``gemm_nt`` on that tail's largest RLB block pair and on one 64 x 64
  pair (row slices of the tail, leading dimension w);

then the device time and launches of each fused-kernel CUDA function in one
warm ``lap3d_40`` factorization, from ``torch.profiler``.  The inputs come
from a seeded generator on the card.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path


def main(tree: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import (
        cached_schedule,
        cholesky,
        device_plan,
        symbolic_pipeline,
    )
    from repro_torch.kernels import _build, fused_factor_syrk, gemm_nt
    from repro_torch.sparse import make_suite_matrix

    _build.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float64)

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def group(rows, ws, Lp, Wp, garbage):
        Bp = len(rows)
        p = randn(Bp, Lp, Wp) if garbage else torch.zeros(
            (Bp, Lp, Wp), device=dev, dtype=torch.float64)
        for b, (r, w) in enumerate(zip(rows, ws)):
            if w:
                G = randn(w, w)
                p[b, :w, :w] = torch.tril(G @ G.T / w + 2 * torch.eye(
                    w, device=dev, dtype=torch.float64))
                p[b, Wp:Wp + r - w, :w] = 0.5 * randn(r - w, w)
        return (p, torch.tensor(rows, dtype=torch.int32, device=dev),
                torch.tensor(ws, dtype=torch.int32, device=dev))

    A = make_suite_matrix("lap3d_40")
    sym, Aperm = symbolic_pipeline(A)
    plan = device_plan(sym, cached_schedule(sym, bucket="fused"))
    groups = [g for lvl in plan.groups for g in lvl]
    largest = max(groups, key=lambda g: (g.Lp * g.Wp, g.Wp))
    tail = max((g for g in groups if g is not largest),
               key=lambda g: ((g.Lp - g.Wp) / g.Wp, g.Lp))
    padded = max((g for g in groups if g.B < g.Bp),
                 key=lambda g: (g.Bp - g.B, g.Bp * g.Lp * g.Wp))
    out = {"tree": tree, "card": torch.cuda.get_device_name(0)}
    for label, g, garbage in (("largest", largest, False),
                              ("tail_heavy", tail, False),
                              ("pad_lanes_garbage", padded, True)):
        Bp, Lp, Wp = g.gidx.shape
        rows = [int(x) for x in g.rows_arr[:Bp]]
        ws = [int(x) for x in g.ws_arr[:Bp]]
        p, r, w = group(rows, ws, Lp, Wp, garbage)
        reps = 3 if Lp * Wp >= 1 << 21 else 10
        out[f"fused {label} ({Bp}, {Lp}, {Wp})"] = ms(
            lambda: fused_factor_syrk(p, r, w), reps)
        if label == "largest":
            out[f"guarded {label} thr 0"] = ms(
                lambda: fused_factor_syrk(p, r, w, guard=True, thr=0.0), 3)
    wsn = np.diff(sym.super_ptr)
    msn = np.array([x.shape[0] for x in sym.rows]) - wsn
    for label, s_ in (("widest", int(np.argmax(wsn))),
                      ("largest_tail", int(np.argmax(msn * wsn)))):
        W, M = int(wsn[s_]), int(msn[s_])
        p, r, w = group([M + W], [W], M + W, W, False)
        out[f"fused seq panel {label} (1, {M + W}, {W})"] = ms(
            lambda: fused_factor_syrk(p, r, w), 3)
    s_ = int(np.argmax(msn * wsn))
    W, M = int(wsn[s_]), int(msn[s_])
    T = 0.5 * randn(M, W)
    for nr, nc in ((580, 620), (64, 64)):
        a, b = T[:nr], T[M - nc:]
        out[f"gemm_nt {nr}x{nc}x{W}"] = ms(lambda: gemm_nt(a, b), 50)
    cholesky(A, sym=sym, Aperm=Aperm)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cholesky(A, sym=sym, Aperm=Aperm)
        torch.cuda.synchronize()
    fused = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        name = ev.key.split("::")[-1].split("(")[0]
        if dev_us > 0 and name in ("mask_kernel", "diag_factor_kernel",
                                   "panel_trsm_kernel", "panel_kernel",
                                   "trailing_kernel", "syrk_kernel"):
            fused[name] = {"ms": dev_us / 1e3, "launches": ev.count}
    out["lap3d_40 fused kernel by function"] = fused
    out["lap3d_40 fused kernel ms"] = sum(v["ms"] for v in fused.values())
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])

#!/usr/bin/env python3
"""Times the fused kernel, ``gemm_nt``, ``tri_inv_lower``, ``trsm_rlt``,
``chol_tile``, ``syrk_ln`` and the blocked ``potrf`` of one checkout of the
repo on the card, so two versions can be compared in one run on one
card:

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
* the guarded kernel on the largest group and on the most batched group
  (Bp = 256), at thr = 0 and at ``lap3d_40``'s perturb threshold;
* ``gemm_nt`` on that tail's largest RLB block pair and on one 64 x 64
  pair (row slices of the tail, leading dimension w);
* ``tri_inv_lower`` on the three groups' factored diagonal blocks (the
  lanes ``fused_factor_syrk`` returns, made contiguous) and on one 128-wide
  block of the blocked ``potrf``;
* ``trsm_rlt`` on the largest tail (M = 1200, W = 669) and on the small
  tail ``chip_smoke.py`` checks (the widest supernode with m <= 64);
* the blocked ``potrf`` on the widest supernode's diagonal block (W =
  1890);
* ``chol_tile`` at n = 128, and over the widths the GPU-only unfused RL
  run of ``lap3d_40`` (``chip_smoke.py`` phase (a)) gives it: one tile per
  128 columns of each supernode, all of them back to back, as one time;
* ``syrk_ln`` on the largest tail (M = 1200, K = 669) and on one 64-row
  RLB block of it;

then the device time and launches of each fused-kernel and
``tri_inv_lower`` CUDA function (and of the memsets) in one warm
``lap3d_40`` factorization and its first device solve, of each CUDA
function in one warm ``guard="raise"`` factorization (the guarded
kernel's device time), the wall seconds of warm ``guard="off"`` and
``guard="raise"`` factorizations in turns, and of every CUDA function of
the port in one phase (a) run (with its wall seconds), from
``torch.profiler``.  Template instances keep their arguments in the names
(``panel_kernel<true>``).  The inputs come from a seeded generator on the
card.
"""
from __future__ import annotations

import json
import re
import sys
import time
from pathlib import Path


def fn_name(key: str) -> str:
    """The function name of a profiler event's key, with its template
    arguments (``void (anonymous namespace)::panel_kernel<true>(double*,
    ..., (anonymous namespace)::GuardSlab)`` gives ``panel_kernel<true>``)."""
    found = re.search(r"::(\w+(?:<[^()]*>)?)\(", key)
    return found.group(1) if found else key.split("(")[0]


def main(tree: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import (
        DeviceEngine,
        cached_schedule,
        cholesky,
        device_plan,
        perturb_threshold,
        symbolic_pipeline,
    )
    from repro_torch.kernels import (
        _build,
        chol_tile,
        fused_factor_syrk,
        gemm_nt,
        ops,
        syrk_ln,
        tri_inv_lower,
        trsm_rlt,
    )
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
    batched = max(groups, key=lambda g: (g.B, g.Lp * g.Wp))
    thr = perturb_threshold(float(np.max(np.abs(A.diagonal()))))
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
        L = fused_factor_syrk(p, r, w)[0][:, :Wp, :].contiguous()
        out[f"tri_inv_lower {label} ({Bp}, {Wp}, {Wp})"] = ms(
            lambda: tri_inv_lower(L), reps)
        del L
        if label == "largest":
            for t in (0.0, thr):
                out[f"guarded {label} thr {t:.3g}"] = ms(
                    lambda: fused_factor_syrk(p, r, w, guard=True, thr=t), 3)
    Bp, Lp, Wp = batched.gidx.shape
    p, r, w = group([int(x) for x in batched.rows_arr[:Bp]],
                    [int(x) for x in batched.ws_arr[:Bp]], Lp, Wp, True)
    for t in (0.0, thr):
        out[f"guarded most batched ({Bp}, {Lp}, {Wp}) thr {t:.3g}"] = ms(
            lambda: fused_factor_syrk(p, r, w, guard=True, thr=t), 10)
    del p, r, w
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
    def spd(W):
        G = randn(W, W)
        return torch.linalg.cholesky(G @ G.T / W + 2 * torch.eye(
            W, device=dev, dtype=torch.float64)).contiguous()

    L = spd(128)[None]
    out["tri_inv_lower potrf block (1, 128, 128)"] = ms(
        lambda: tri_inv_lower(L), 50)
    small = [x for x in range(len(wsn)) if 1 <= msn[x] <= 64]
    s_small = max(small, key=lambda x: (wsn[x], msn[x]))
    for label, s_ in (("largest tail", int(np.argmax(msn * wsn))),
                      ("small tail", s_small)):
        W, M = int(wsn[s_]), int(msn[s_])
        L, B = spd(W), randn(M, W)
        out[f"trsm_rlt {label} M={M} W={W}"] = ms(lambda: trsm_rlt(L, B),
                                                  20)
    def spd_lower(W):  # an SPD matrix by its lower triangle
        L_ = spd(W)
        return torch.tril(L_ @ L_.mT)

    W = int(wsn.max())
    A_ = spd_lower(W)
    out[f"potrf W={W}"] = ms(lambda: ops.potrf(A_), 5)
    del A_, L, B
    tiles = {}  # the tile widths of phase (a)'s potrf calls, and spd tiles
    for w_ in (int(x) for x in wsn):
        for k0 in range(0, w_, 128):
            n_ = min(128, w_ - k0)
            tiles[n_] = tiles.get(n_, 0) + 1
    spd_tiles = {n_: spd_lower(n_) for n_ in tiles}
    out["chol_tile n=128"] = ms(lambda: chol_tile(spd_tiles[128]), 50)
    mix = [spd_tiles[n_] for n_, c in sorted(tiles.items()) for _ in range(c)]

    def run_mix():
        for t in mix:
            chol_tile(t)

    out[f"chol_tile phase (a) width mix ({len(mix)} calls), total"] = ms(
        run_mix, 2)
    Mt, Kt = T.shape
    out[f"syrk_ln tail M={Mt} K={Kt}"] = ms(lambda: syrk_ln(T), 20)
    Tb = T[:64]
    out[f"syrk_ln RLB block M=64 K={Kt}"] = ms(lambda: syrk_ln(Tb), 50)
    del spd_tiles, mix
    # the diagonal blocks are inverted once per group, at the first solve
    b = np.ones(A.shape[0])
    cholesky(A, sym=sym, Aperm=Aperm).solve(b, backend="device")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cholesky(A, sym=sym, Aperm=Aperm).solve(b, backend="device")
        torch.cuda.synchronize()
    kernels = {  # the CUDA functions of each kernel, this PR's and before
        "fused": ("mask_kernel", "diag_factor_kernel", "panel_trsm_kernel",
                  "panel_kernel", "trailing_kernel", "syrk_kernel"),
        "tri_inv_lower": ("diag_inv_kernel", "offdiag_kernel",
                          "inv_diag_kernel", "level_t_kernel",
                          "level_x_kernel"),
    }
    by = {k: {} for k in kernels}
    memset = {"ms": 0.0, "launches": 0}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        name = fn_name(ev.key)
        if dev_us <= 0:
            continue
        if "memset" in ev.key.lower():
            memset["ms"] += dev_us / 1e3
            memset["launches"] += ev.count
        for k, names in kernels.items():
            if name.split("<")[0] in names:
                by[k][name] = {"ms": dev_us / 1e3, "launches": ev.count}
    for k, fns in by.items():
        out[f"lap3d_40 {k} kernel by function"] = fns
        out[f"lap3d_40 {k} kernel ms"] = sum(v["ms"] for v in fns.values())
    out["lap3d_40 memsets"] = memset

    def port_kernels(prof):
        fns = {}
        for ev in prof.key_averages():
            dev_us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0.0))
            if dev_us > 0 and "anonymous namespace" in ev.key:
                name = fn_name(ev.key)
                fns[name] = {"ms": dev_us / 1e3, "launches": ev.count}
        return fns

    # one warm guard="raise" factorization: the guarded kernel's functions
    # (the fused kernel's, the guarded panel, the check and sweep, the init)
    cholesky(A, sym=sym, Aperm=Aperm, guard="raise")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cholesky(A, sym=sym, Aperm=Aperm, guard="raise")
        torch.cuda.synchronize()
    fns = {k: v for k, v in port_kernels(prof).items()
           if k.split("<")[0] in kernels["fused"] + (
               "guarded_slab_kernel", "status_init_kernel",
               "guard_init_kernel")}
    out["lap3d_40 guard=raise fused kernels by function"] = fns
    out["lap3d_40 guard=raise fused kernels ms"] = sum(
        v["ms"] for v in fns.values())
    walls = {"off": [], "raise": []}
    for guard in ("off", "raise", "off", "raise"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cholesky(A, sym=sym, Aperm=Aperm, guard=guard)
        torch.cuda.synchronize()
        walls[guard].append(time.perf_counter() - t0)
    out["lap3d_40 warm factor seconds by guard"] = walls
    # phase (a): RL, every supernode on the card, unfused (potrf, trsm_rlt,
    # syrk_ln), warm; then the same run under the profiler
    def phase_a():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cholesky(A, method="rl", schedule="seq", offload_threshold=0,
                 device_engine=DeviceEngine(fused=False), sym=sym,
                 Aperm=Aperm)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    out["phase (a) seconds"] = [phase_a(), phase_a()]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        phase_a()
    fns = port_kernels(prof)
    out["phase (a) kernels by function"] = fns
    out["phase (a) device ms of the port's kernels"] = sum(
        v["ms"] for v in fns.values())
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])

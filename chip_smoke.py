#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card:

    python3 chip_smoke.py

1. card info from ``nvidia-smi`` (fails without a CUDA card);
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together, into ``build/kernels/``),
   prints each kernel's ``ptxas`` registers and spills, and counts the
   fp64 tensor-core instructions (DMMA) in the SASS of the DMMA kernels;
3. holds each kernel against its plain PyTorch version and times kernel,
   plain version and a library yardstick: ``fused_factor_syrk`` and
   ``tri_inv_lower`` on group buffers of ``lap3d_40``'s fused schedule (the
   largest group, a tail-heavy group, a group with pad lanes and garbage pad
   cells) and ``tri_inv_lower`` on one 128-wide block (potrf's step
   width); ``potrf`` (with ``chol_tile``), ``chol_tile`` alone at n = 128,
   65, 33 and 8 (its 128, 64 and one-warp variants; n = 65 stops the 128
   variant after 8 of its 15 steps), ``trsm_rlt``,
   ``syrk_ln`` (and its subtract form at potrf's first step), ``gemm_nt``
   and the one-panel ``fused_factor_syrk`` at the shapes the sequential
   path gives them on ``lap3d_40`` (its widest supernode, its largest tail
   and one small tail, one 64-row RLB block, the largest tail's largest
   RLB block pair and one small 64 x 64 pair); the kernel launches of
   every call checked, counted by ``torch.profiler``, against the formula
   of its launch loop;
4. drives the levels main path — ``cholesky(A)`` then
   ``F.solve(b, backend="device")`` with 1 and 64 right-hand sides — on
   ``lap3d_40`` and ``kkt_256``, and checks residuals, dispatch and transfer
   counts, the upload-before-dispatch order, the launch counts, and
   (kkt_256) the card's factor against the port's own CPU run;
5. drives the paper's sequential paths and the mixed levels path: (a) RL,
   every supernode on the card through potrf, trsm_rlt and syrk_ln; (b) RL
   at the paper's 600,000 threshold with the fused kernel; (c) RLB at
   750,000, with and without batched transfers; (d) RLB on the card only,
   unfused, on ``kkt_256``; (e) the mixed levels path at 600,000; (f) the
   host-only RL baseline; (g) the device solve of (b)'s host factor; (h)
   (a)'s factor against the port's CPU run of the same call.  Each checks
   its residual, engine counts and per-kernel launches, and prints its
   wall time;
6. holds the guarded fused kernel against its plain version (lap3d_40's
   widest group, its most batched group, and the kkt_saddle_64 groups
   whose lanes clamp; each at thr = 0 and at the perturb threshold) beside
   the unguarded kernel's time on the same buffers, with the (lane, slab)
   pairs its check routed to the column sweep and its launches traced at
   both thresholds;
7. drives the breakdown guard through ``cholesky(guard=...)``: ``raise`` on
   lap3d_40 against ``guard="off"``, and the reference's breakdown suite
   (kkt_saddle_64 under raise, perturb and shift; neumann_64 and gram_400
   under perturb; badscale_64 under raise), the raise and perturb calls
   against the port's CPU run of the same call, with refined device
   solves;
8. drives ``cholesky_many`` on four shifted copies of lap3d_40 (guard off
   and raise) against four ``cholesky`` calls, its batched solve, and the
   warm ``cholesky(A, plan=PlanCache().get(A))`` against the warm call
   without a plan;
9. the solver server (``repro_torch.launch.serve``): (a) a stream of 16
   requests over two 2-D Laplacian patterns of grid 256 (n = 65,536 and
   66,049) with batched requests of M = 4 under ``guard="raise"``, its
   factorizations and solves per second and first- against repeat-pattern
   factor seconds; (b) the CLI run twice on one cache directory, the
   second serving from disk; (c) the fault tests' scenarios on the card
   (an injected dispatch failure, every dispatch failing, the plain tier
   down too, a corrupted upload, a poisoned pool, the chaos and perturb
   streams), each with what its plan fired and the exact fallbacks, and
   the cost of a step down a tier; (d) the stream of (a), 6 requests,
   with ``verify=True``; (e) the three-dispatch oracle on ``lap3d_40``;
10. prints a ``kernels`` JSON line, the card's name and power limit, and the
   result line ``{"ok": true, "device": {...}}`` last.

numpy's BLAS runs one thread here unless ``OPENBLAS_NUM_THREADS`` is set.

Every path runs with the kernels' launch counters, and the engines' tally
of steps down the group fallback chain, set to 0 just before it and read
just after; a step down fails every path but the chaos phase.  Any failed check raises, so the script exits non-zero
and prints no result line.  It imports nothing of JAX or of the reference
package ``repro``.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

# numpy's threaded OpenBLAS spins on the host paths' many small supernodes
# (scripts/seq_breakdown.py: the host-only RL of lap3d_40 ran about 10x
# slower with the default threads than with one), so the host engine gets
# its best setting unless the caller chose one; set before numpy loads
os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent
SEED = 0
#: torch device of the made-up kernel inputs (the card; "cpu" only to
#: rehearse the script's control flow against the plain versions)
DEV = "cuda"
REL_TOL = 1e-10     # kernel vs plain version, relative to max |plain|
RESID_TOL = 1e-10   # ||A x - b|| / ||b||

#: (fp64 tensor-core FLOP/s, device memory bytes/s) from NVIDIA's data sheets
PEAKS = {"sxm": (67e12, 3.35e12), "pcie": (51e12, 2.0e12)}
#: the paper's offload thresholds (rows * w) for RL and RLB on an A100
PAPER_THRESHOLD = {"rl": 600_000, "rlb": 750_000}
#: the port's kernel wrappers, as ``repro_torch.kernels.KERNELS`` lists them
KERNEL_NAMES = ("fused_factor_syrk", "tri_inv_lower", "trsm_rlt", "chol_tile",
                "syrk_ln", "gemm_nt", "fused_factor_syrk_guarded")


def card_info():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    peaks = PEAKS["pcie" if "PCIe" in kind else "sxm"]
    print(f"card: {kind}; nvidia-smi: {smi}; count "
          f"{torch.cuda.device_count()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; peaks fp64 {peaks[0]:.3g} FLOP/s, "
          f"{peaks[1]:.3g} B/s", flush=True)
    return smi, kind, peaks


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls after one
    warm-up call, timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(x, ref) -> tuple[float, float]:
    """(max abs difference, that over max |ref|)."""
    import torch

    if ref.numel() == 0:
        return 0.0, 0.0
    d = float(torch.max(torch.abs(x - ref)))
    return d, d / max(float(torch.max(torch.abs(ref))), 1e-300)


def make_group(g, garbage: bool, gen):
    """A stacked group buffer at the plan's true extents: SPD diagonal
    blocks and random tails, made on the card from a seeded generator.  Pad
    cells (and pad lanes) hold random garbage when ``garbage``, else 0."""
    import torch

    Bp, Lp, Wp = g.gidx.shape
    dev = torch.device(DEV)
    p = (torch.randn((Bp, Lp, Wp), generator=gen, device=dev,
                     dtype=torch.float64) if garbage
         else torch.zeros((Bp, Lp, Wp), device=dev, dtype=torch.float64))
    for b in range(g.B):
        r, w = int(g.rows_arr[b]), int(g.ws_arr[b])
        G = torch.randn((w, w), generator=gen, device=dev, dtype=torch.float64)
        D = G @ G.T / w + 2.0 * torch.eye(w, device=dev, dtype=torch.float64)
        p[b, :w, :w] = torch.where(
            torch.ones(w, w, device=dev, dtype=torch.bool).tril(), D,
            p[b, :w, :w])
        p[b, Wp:Wp + r - w, :w] = 0.5 * torch.randn(
            (r - w, w), generator=gen, device=dev, dtype=torch.float64)
    rows = torch.tensor(g.rows_arr, dtype=torch.int32, device=dev)
    ws = torch.tensor(g.ws_arr, dtype=torch.int32, device=dev)
    return p, rows, ws


def fused_work(g) -> tuple[float, float]:
    """(flops, bytes) the fused function needs at the group's true extents:
    w^3/3 + m w^2 + m^2 w flops a lane; each real lane's true input cells
    (the lower triangle of its diagonal block and its m x w tail) read once,
    the int32 ``rows`` and ``ws`` read once, and the whole ``fp`` and ``u``
    outputs written once."""
    Bp, Lp, Wp = g.gidx.shape
    mp = Lp - Wp
    flops, cells = 0.0, 0.0
    for b in range(g.B):
        w = float(g.ws_arr[b])
        m = float(g.rows_arr[b]) - w
        flops += w ** 3 / 3 + m * w * w + m * m * w
        cells += w * (w + 1) / 2 + m * w
    nbytes = 8.0 * (cells + Bp * Lp * Wp + Bp * mp * mp) + 8.0 * Bp
    return flops, nbytes


def fused_launches(Bp: int, Lp: int, Wp: int, guard: bool = False) -> int:
    """Kernel launches of one fused call, from the slab loop of
    ``csrc/fused_factor_syrk.cu``: the mask pass (and, guarded, the guard
    init), per 64-column slab the panel launch (guarded: then the check,
    which sweeps the lanes it routes) and, while real columns remain right
    of the slab, the trailing launch, then the SYRK when Lp > Wp.  The
    memset of ``u`` is not a kernel.  The guarded count does not depend on
    thr or on how many lanes are swept."""
    nb = min(Wp, 64)
    n = 2 if guard else 1
    for k0 in range(0, Wp, nb):
        n += 1 + guard + (Wp > k0 + nb)
    return n + (Lp > Wp)


def traced(fn, reps: int = 1) -> tuple[float, float]:
    """(kernel launches, device ms) of the port's kernels per call of
    ``fn``, from a ``torch.profiler`` trace of ``reps`` calls: the
    device-side events of the kernels of ``csrc/`` (their names carry the
    sources' anonymous namespace).  The tracer is warmed inside its window
    first, so its start-up drops no event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").sum().item()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    n, us = 0, 0.0
    for ev in prof.events():
        if (ev.device_type == DeviceType.CUDA
                and "anonymous namespace" in ev.name):
            n += 1
            us += getattr(ev, "device_time_total",
                          getattr(ev, "cuda_time_total", 0.0))
    return n / reps, us / 1e3 / reps


def check_launches(what: str, fn, want: int) -> dict:
    """The trace's launch count of one call against the slab formula, and
    the call's device time.  The tracer drops an event now and then (seen
    on the card: a guarded call traced 3 of its 6 launches in one session
    and all 6 in the next), and a drop can only lower the count, so up to
    three traces are taken and the highest count is held to the formula."""
    got, dev_ms = traced(fn)
    for _ in range(2):
        if got == want:
            break
        got, dev_ms = max((got, dev_ms), traced(fn))
    if got != want:
        raise AssertionError(f"{what}: {got} kernel launches in the trace, "
                             f"{want} from the slab formula")
    return {"device_launches_per_call": int(got), "device_ms": dev_ms}


def kernel_phase(plan, peaks):
    """The fused kernel and tri_inv_lower against their plain versions on
    three groups of lap3d_40, and tri_inv_lower on one 128-wide block."""
    import torch

    from repro_torch.kernels.fused import (
        _mask,
        fused_factor_syrk,
        fused_factor_syrk_ref,
    )
    from repro_torch.kernels.potrf import NB

    groups = [g for lvl in plan.groups for g in lvl]
    largest = max(groups, key=lambda g: (g.Lp * g.Wp, g.Wp))
    tail = max((g for g in groups if g is not largest),
               key=lambda g: ((g.Lp - g.Wp) / g.Wp, g.Lp))
    padded = max((g for g in groups if g.B < g.Bp),
                 key=lambda g: (g.Bp - g.B, g.Bp * g.Lp * g.Wp))
    cases = [("largest", largest, False), ("tail_heavy", tail, False),
             ("pad_lanes_garbage", padded, True)]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    results = {"fused_factor_syrk": [], "tri_inv_lower": []}
    for label, g, garbage in cases:
        Bp, Lp, Wp = g.gidx.shape
        mp = Lp - Wp
        p, rows, ws = make_group(g, garbage, gen)
        fp, u = fused_factor_syrk(p, rows, ws)
        torch.cuda.synchronize()
        fr, ur = fused_factor_syrk_ref(p, rows, ws)
        afp, efp = rel_err(fp, fr)
        au, eu = rel_err(u, ur)
        if not (efp <= REL_TOL and eu <= REL_TOL):
            raise AssertionError(
                f"fused_factor_syrk {label}: rel err fp {efp:.3e} u {eu:.3e}")
        reps = 3 if Lp * Wp >= 1 << 21 else 10
        ms = cuda_ms(lambda: fused_factor_syrk(p, rows, ws), reps)
        plain_ms = cuda_ms(lambda: fused_factor_syrk_ref(p, rows, ws), reps)
        a = _mask(p, rows, ws)
        D = a[:, :Wp, :]
        S = D + torch.tril(D, -1).mT
        B = a[:, Wp:, :].mT

        def library():
            L = torch.linalg.cholesky(S)
            if mp:
                T = torch.linalg.solve_triangular(L, B, upper=False).mT
                torch.tril(T @ T.mT)

        lib_ms = cuda_ms(library, reps)
        flops, nbytes = fused_work(g)
        bound = max(flops / peaks[0], nbytes / peaks[1]) * 1e3
        rec = dict(case=label, Bp=Bp, B=g.B, Lp=Lp, Wp=Wp,
                   max_abs_err=max(afp, au), rel_err=max(efp, eu), ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                   bound_by="operations" if flops / peaks[0]
                   >= nbytes / peaks[1] else "bytes", gflop=flops / 1e9)
        rec.update(check_launches(f"fused_factor_syrk {label}",
                                  lambda: fused_factor_syrk(p, rows, ws),
                                  fused_launches(Bp, Lp, Wp)))
        results["fused_factor_syrk"].append(rec)
        print("kernel fused_factor_syrk", json.dumps(rec), flush=True)

        # the lanes as invert_diag passes them: a view of the factored group
        results["tri_inv_lower"].append(tri_inv_case(
            label, fp[:, :Wp, :], g.ws_arr[:g.B], reps, peaks))
        del p, fp, u, fr, ur, a, D, S, B
        torch.cuda.empty_cache()
    # one 128-wide block, the width of a blocked potrf step
    G = torch.randn((NB, NB), generator=gen, device="cuda",
                    dtype=torch.float64)
    Lb = torch.linalg.cholesky(G @ G.T / NB + 2.0 * torch.eye(
        NB, device="cuda", dtype=torch.float64)).contiguous()[None]
    results["tri_inv_lower"].append(tri_inv_case(
        f"potrf block {NB}", Lb, [NB], 10, peaks))
    return results


def tri_inv_case(label, L, ws, reps, peaks) -> dict:
    """``tri_inv_lower`` on the (Bp, Wp, Wp) lanes ``L`` (lane widths
    ``ws``): against its plain version, timed beside the library call, its
    launches traced against ``tri_inv_launches``."""
    import torch

    from repro_torch.kernels.trsm import (
        tri_inv_launches,
        tri_inv_lower,
        tri_inv_lower_ref,
    )

    Bp, Wp, _ = L.shape
    X = tri_inv_lower(L)
    torch.cuda.synchronize()
    Xr = tri_inv_lower_ref(L)
    ax, ex = rel_err(X, Xr)
    if not ex <= REL_TOL:
        raise AssertionError(f"tri_inv_lower {label}: rel err {ex:.3e}")
    ms = cuda_ms(lambda: tri_inv_lower(L), reps)
    plain_ms = cuda_ms(lambda: tri_inv_lower_ref(L), reps)
    eye = torch.eye(Wp, dtype=torch.float64, device="cuda").expand_as(L)
    lib_ms = cuda_ms(
        lambda: torch.linalg.solve_triangular(L, eye, upper=False), reps)
    flops = sum(float(w) ** 3 / 3 for w in ws)
    # the lower triangle of each input lane read, the whole output written
    nbytes = 8.0 * Bp * (Wp * (Wp + 1) / 2 + Wp * Wp)
    bound, by = work_bound(flops, nbytes, peaks)
    rec = dict(case=label, Bp=Bp, B=len(ws), Wp=Wp, max_abs_err=ax,
               rel_err=ex, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bound, bound_by=by, gflop=flops / 1e9)
    rec.update(check_launches(f"tri_inv_lower {label}",
                              lambda: tri_inv_lower(L),
                              tri_inv_launches(Wp)))
    print("kernel tri_inv_lower", json.dumps(rec), flush=True)
    return rec


def work_bound(flops: float, nbytes: float, peaks) -> tuple[float, str]:
    """(least ms for the work, what bounds it) from the card's peaks."""
    t_ops, t_bytes = flops / peaks[0], nbytes / peaks[1]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def seq_kernel_phase(sym, peaks):
    """potrf (the blocked routine), chol_tile, trsm_rlt, syrk_ln, gemm_nt
    and fused_factor_syrk against their plain versions at the shapes the
    sequential path gives them on this matrix: the widest supernode's
    diagonal block, the largest tail (max m*w: its diagonal block, its TRSM
    and its update SYRK) and that tail's largest RLB block pair; the fused
    kernel on both supernodes' whole panels, as ``DeviceEngine(fused=True)``
    passes them.  The seq path stages exact panels, so these are the
    supernodes' own widths (a ragged Wp with no pad columns), not
    buckets."""
    import torch

    from repro_torch.core.relind import supernode_blocks
    from repro_torch.kernels import (
        chol_tile,
        chol_tile_ref,
        fused_factor_syrk,
        fused_factor_syrk_ref,
        gemm_nt,
        gemm_nt_ref,
        ops,
        potrf_ref,
        syrk_ln,
        syrk_ln_ref,
        syrk_ln_sub,
        syrk_ln_sub_ref,
        trsm_rlt,
        trsm_rlt_ref,
    )
    from repro_torch.kernels.potrf import NB

    ws = np.diff(sym.super_ptr)
    ms = np.array([r.shape[0] for r in sym.rows]) - ws
    s_wide = int(np.argmax(ws))
    s_tail = int(np.argmax(ms * ws))
    w, m = int(ws[s_tail]), int(ms[s_tail])
    blocks = supernode_blocks(sym, s_tail)
    nr, nc = max(((b2.k1 - b2.k0, b.k1 - b.k0)
                  for i, b in enumerate(blocks) for b2 in blocks[i + 1:]),
                 key=lambda p: p[0] * p[1])
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float64)

    def spd_lower(W):  # a panel's diagonal block: lower triangle, zeros above
        G = randn(W, W)
        return torch.tril(G @ G.T / W
                          + 2.0 * torch.eye(W, device=dev, dtype=torch.float64))

    def sym_of(A):
        return A + torch.tril(A, -1).mT

    cases = []   # (kernel, label, fn, plain, library, flops, bytes)
    for s_, tag in ((s_wide, "widest"), (s_tail, "largest_tail")):
        W = int(ws[s_])
        A = spd_lower(W)
        S = sym_of(A)
        cases.append(("potrf", f"{tag} W={W}", lambda A=A: ops.potrf(A),
                      lambda A=A: potrf_ref(A),
                      lambda S=S: torch.linalg.cholesky(S), W ** 3 / 3,
                      8.0 * (W * (W + 1) / 2 + W * W)))
    for n in (128, 65, 33, 8):  # potrf's tile first: the kernels line's
        A = spd_lower(n)
        S = sym_of(A)
        cases.append(("chol_tile", f"potrf tile n={n}" if n == 128
                      else f"tile n={n}",
                      lambda A=A: chol_tile(A), lambda A=A: chol_tile_ref(A),
                      lambda S=S: torch.linalg.cholesky(S),
                      n ** 3 / 3, 8.0 * (n * (n + 1) / 2 + n * n)))
    L = torch.linalg.cholesky(sym_of(spd_lower(w))).contiguous()
    B = randn(m, w)
    cases.append(("trsm_rlt", f"tail M={m} W={w}", lambda: trsm_rlt(L, B),
                  lambda: trsm_rlt_ref(L, B),
                  lambda: torch.linalg.solve_triangular(L.mT, B, upper=True,
                                                        left=False),
                  float(m) * w * w, 8.0 * (w * (w + 1) / 2 + 2 * m * w)))
    # a small tail of the same path: the widest supernode with m <= 64
    small = [s for s in range(len(ws)) if 1 <= ms[s] <= 64]
    s_small = max(small, key=lambda s: (ws[s], ms[s]))
    ws_, ms_ = int(ws[s_small]), int(ms[s_small])
    Ls = torch.linalg.cholesky(sym_of(spd_lower(ws_))).contiguous()
    Bs = randn(ms_, ws_)
    cases.append(("trsm_rlt", f"small tail M={ms_} W={ws_}",
                  lambda: trsm_rlt(Ls, Bs), lambda: trsm_rlt_ref(Ls, Bs),
                  lambda: torch.linalg.solve_triangular(
                      Ls.mT, Bs, upper=True, left=False),
                  float(ms_) * ws_ * ws_,
                  8.0 * (ws_ * (ws_ + 1) / 2 + 2 * ms_ * ws_)))
    T = 0.5 * randn(m, w)
    cases.append(("syrk_ln", f"tail M={m} K={w}", lambda: syrk_ln(T),
                  lambda: syrk_ln_ref(T), lambda: torch.tril(T @ T.mT),
                  float(m) * m * w, 8.0 * (m * w + m * m)))
    Tb = T[:64]  # one RLB diagonal block update: a 64-row block of the tail
    cases.append(("syrk_ln", f"RLB block M=64 K={w}", lambda: syrk_ln(Tb),
                  lambda: syrk_ln_ref(Tb), lambda: torch.tril(Tb @ Tb.mT),
                  64.0 * 64 * w, 8.0 * (64 * w + 64 * 64)))
    # the subtract form at potrf's first step on the widest supernode: the
    # trailing matrix (a zero upper triangle, as in potrf's buffer) less
    # X X^T, in place; every timed call subtracts again
    Wd = int(ws[s_wide])
    Ms = Wd - NB
    X = 0.1 * randn(Ms, NB)
    C0 = spd_lower(Ms)
    C1, C2, C3 = C0.clone(), C0.clone(), C0.clone()
    cases.append(("syrk_ln", f"potrf step sub M={Ms} K={NB}",
                  lambda: syrk_ln_sub(C1, X), lambda: syrk_ln_sub_ref(C2, X),
                  lambda: C3.sub_(torch.tril(X @ X.mT)),
                  float(Ms) * Ms * NB,
                  8.0 * (Ms * NB + Ms * (Ms + 1))))
    Ra, Rb = T[:nr], T[m - nc:]
    cases.append(("gemm_nt", f"RLB pair M={nr} N={nc} K={w}",
                  lambda: gemm_nt(Ra, Rb), lambda: gemm_nt_ref(Ra, Rb),
                  lambda: Ra @ Rb.mT, 2.0 * nr * nc * w,
                  8.0 * (nr * w + nc * w + nr * nc)))
    # a small RLB pair of the same tail: one 64 x 64 tile, launch bound
    Sa, Sb = T[:64], T[m - 64:]
    cases.append(("gemm_nt", f"small RLB pair M=64 N=64 K={w}",
                  lambda: gemm_nt(Sa, Sb), lambda: gemm_nt_ref(Sa, Sb),
                  lambda: Sa @ Sb.mT, 2.0 * 64 * 64 * w,
                  8.0 * (64 * w + 64 * w + 64 * 64)))
    for s_, tag in ((s_wide, "widest"), (s_tail, "largest_tail")):
        # one exact panel (1, rows, w), as DeviceEngine.factor stages it
        W, M = int(ws[s_]), int(ms[s_])
        P = torch.cat([spd_lower(W), 0.5 * randn(M, W)])[None].contiguous()
        ext = torch.tensor([[M + W], [W]], dtype=torch.int32, device=dev)
        S = sym_of(P[0, :W])
        Tt = P[0, W:].mT

        def library(S=S, Tt=Tt):
            L = torch.linalg.cholesky(S)
            if Tt.shape[1]:
                T = torch.linalg.solve_triangular(L, Tt, upper=False).mT
                torch.tril(T @ T.mT)

        cases.append((
            "fused_factor_syrk", f"{tag} panel rows={M + W} w={W}",
            lambda P=P, ext=ext: fused_factor_syrk(P, ext[0], ext[1]),
            lambda P=P, ext=ext: fused_factor_syrk_ref(P, ext[0], ext[1]),
            library, W ** 3 / 3 + float(M) * W * W + float(M) * M * W,
            8.0 * (W * (W + 1) / 2 + M * W + (M + W) * W + M * M) + 8.0))
    launch_of = {"chol_tile": chol_tile, "trsm_rlt": trsm_rlt,
                 "syrk_ln": syrk_ln, "gemm_nt": gemm_nt,
                 "fused_factor_syrk": fused_factor_syrk}
    results: dict = {}
    for name, label, fn, plain, library, flops, nbytes in cases:
        counter = launch_of.get(name, chol_tile)
        before = counter.launches
        out = fn()
        torch.cuda.synchronize()
        per_call = counter.launches - before
        ref = plain()
        # the fused kernel returns (fp, u): the worst of the two
        errs = [rel_err(o, r) for o, r in zip(
            out if isinstance(out, tuple) else (out,),
            ref if isinstance(ref, tuple) else (ref,))]
        aerr, rerr = max(e[0] for e in errs), max(e[1] for e in errs)
        if not rerr <= REL_TOL:
            raise AssertionError(f"{name} {label}: rel err {rerr:.3e}")
        if name == "syrk_ln" and torch.triu(out, 1).any():
            raise AssertionError("syrk_ln wrote above the diagonal")
        reps = 3 if flops > 1e9 else 10
        ms_ = cuda_ms(fn, reps)
        plain_ms = cuda_ms(plain, reps)
        lib_ms = cuda_ms(library, reps)
        bound, by = work_bound(flops, nbytes, peaks)
        rec = dict(case=label, max_abs_err=aerr, rel_err=rerr, ms=ms_,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                   bound_by=by, gflop=flops / 1e9,
                   launches_per_call=per_call)
        if name == "fused_factor_syrk":
            _, Lp_, Wp_ = out[0].shape
            rec.update(check_launches(f"fused_factor_syrk {label}", fn,
                                      fused_launches(1, Lp_, Wp_)))
        elif name == "potrf":  # chol_tile a step, trsm_rlt + syrk_ln below
            steps = -(-out.shape[0] // NB)
            rec.update(check_launches(f"potrf {label}", fn, 3 * steps - 2))
        else:  # one launch a call
            rec.update(check_launches(f"{name} {label}", fn, 1))
        results.setdefault(name, []).append(rec)
        print(f"kernel {name}", json.dumps(rec), flush=True)
    torch.cuda.empty_cache()
    return results


def check_events(events, nlev: int) -> None:
    """Level k+1's upload is logged before level k's first dispatch."""
    ev = list(events)
    for k in range(nlev - 1):
        up = ev.index(("upload", k + 1))
        disp = ev.index(("dispatch", k))
        if not up < disp:
            raise AssertionError(f"upload of level {k + 1} after dispatch of "
                                 f"level {k}")


def main_path(name: str, sym, Aperm, A, launches_of):
    """Factor and solve one matrix through the user entry points."""
    import torch

    from repro_torch.core import DeviceEngine, cholesky

    n = A.shape[0]
    ws = np.diff(sym.super_ptr).astype(np.float64)
    ms = np.array([r.shape[0] for r in sym.rows], dtype=np.float64) - ws
    out = {"matrix": name, "n": n, "supernodes": sym.nsuper,
           "max_width": int(ws.max()),
           "gflop": float(np.sum(ws ** 3 / 3 + ms * ws ** 2
                                 + ms ** 2 * ws)) / 1e9}
    eng = DeviceEngine()
    before = launches_of()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    F = cholesky(A, device_engine=eng, sym=sym, Aperm=Aperm)
    out["factor_s_first"] = time.perf_counter() - t0
    stats = dict(eng.stats)
    sb = F.stats["schedule"]
    nlev, ngroups = sb["levels"], sb["batches"]
    out.update(levels=nlev, groups=ngroups, stats=stats)
    if stats["device_calls"] != ngroups:
        raise AssertionError(f"{name}: device_calls {stats['device_calls']} "
                             f"!= groups {ngroups}")
    if stats["transfers_in"] != 1 + nlev or stats["transfers_out"] != 1:
        raise AssertionError(f"{name}: transfers {stats} (want in 1 + "
                             f"{nlev}, out 1)")
    check_events(eng.events, nlev)
    out["factor_launches"] = {k: v - before[k]
                              for k, v in launches_of().items()}
    # steady state: the schedule and device plan are cached on sym
    eng2 = DeviceEngine()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    F2 = cholesky(A, device_engine=eng2, sym=sym, Aperm=Aperm)
    out["factor_s_warm"] = time.perf_counter() - t0
    # the group assembly adds up in a fixed order: a second run is equal
    diff = np.max(np.abs(F2.store.storage - F.store.storage))
    if not np.array_equal(F2.store.storage, F.store.storage):
        raise AssertionError(f"{name}: a second factorization differs by "
                             f"{diff:.3e}")
    del F2, eng2
    rng = np.random.default_rng(SEED)
    for k in (1, 64):
        b = rng.standard_normal(n if k == 1 else (n, k))
        for tag in ("first", "warm"):
            t0 = time.perf_counter()
            x = F.solve(b, backend="device")
            out[f"solve{k}_s_{tag}"] = time.perf_counter() - t0
        res = float(np.linalg.norm(A @ x - b) / np.linalg.norm(b))
        out[f"resid{k}"] = res
        if not (np.all(np.isfinite(x)) and x.shape == b.shape
                and res <= RESID_TOL):
            raise AssertionError(f"{name}: residual {res:.3e} with {k} RHS")
    out["launches"] = {k: v - before[k] for k, v in launches_of().items()}
    return F, out


def seq_expect(sym, thr: int, method: str, fused: bool, bt: bool = False):
    """What a sequential run must count: per-kernel launches and engine
    stats, from the supernodes with rows*w >= thr and the engine's protocol
    (potrf: one chol_tile per NB = 128 columns and one trsm_rlt and one
    subtracting syrk_ln per step below the last; one trsm_rlt per tail,
    which inverts its diagonal blocks itself; RL one syrk_tail, RLB one
    syrk_ln per block and one gemm_nt per block pair)."""
    from repro_torch.core.relind import supernode_blocks
    from repro_torch.kernels.potrf import NB

    launches = dict.fromkeys(KERNEL_NAMES, 0)
    st = {"transfers_in": 0, "transfers_out": 0, "device_calls": 0}
    ndev = 0
    for s in range(sym.nsuper):
        w = sym.width(s)
        m = sym.rows[s].shape[0] - w
        if sym.size(s) < thr:
            continue
        ndev += 1
        st["transfers_in"] += 1    # stage
        st["device_calls"] += 1    # factor
        st["transfers_out"] += 1   # read_panel
        if fused:
            launches["fused_factor_syrk"] += 1
        else:
            steps = -(-w // NB)
            launches["chol_tile"] += steps
            for k in ("trsm_rlt", "syrk_ln"):
                launches[k] += steps - 1
            if m:
                launches["trsm_rlt"] += 1
        if not m:
            continue
        if method == "rl":
            st["transfers_out"] += 1
            if not fused:
                st["device_calls"] += 1
                launches["syrk_ln"] += 1
        else:
            nb = len(supernode_blocks(sym, s))
            pairs = nb * (nb - 1) // 2
            launches["syrk_ln"] += nb
            launches["gemm_nt"] += pairs
            st["device_calls"] += nb + pairs
            st["transfers_out"] += 1 if bt else nb + pairs
    return launches, st, ndev


def run_path(fns: dict, totals: dict, fn, steps_down: bool = False):
    """Run one path with every launch counter, and the engines' tally of
    steps down the group fallback chain, at 0 just before it; return
    (result, wall seconds, launches), adding the launches to ``totals``.
    A step down fails the path unless ``steps_down`` (the chaos phase)."""
    import torch

    from repro_torch.core import engines

    for f in fns.values():
        f.launches = 0
    for k in engines.STEPS_DOWN:
        engines.STEPS_DOWN[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = {k: f.launches for k, f in fns.items()}
    for k, v in got.items():
        totals[k] += v
    if any(engines.STEPS_DOWN.values()) and not steps_down:
        raise AssertionError(f"a group stepped down the fallback chain: "
                             f"{engines.STEPS_DOWN}")
    return out, secs, got


def residual(A, x, b) -> float:
    return float(np.linalg.norm(A @ x - b) / np.linalg.norm(b))


def seq_phases(mats, fns, totals):
    """Phases (a)-(h): the paper's sequential paths and the mixed levels
    path through ``cholesky``, the host-only baseline, and the device solve
    of a host factor."""
    import torch

    from repro_torch.core import (
        DeviceEngine,
        cached_schedule,
        cholesky,
        factorize_rl,
    )
    from repro_torch.core.relind import count_blas_calls

    rng = np.random.default_rng(SEED)
    out = {}

    def check(label, F, A, eng, expect, secs, got, b):
        want_l, want_st, ndev = expect
        res = residual(A, F.solve(b), b)
        rec = {"phase": label, "seconds": secs, "resid": res,
               "supernodes_on_device": F.stats["supernodes_on_device"],
               "supernodes_total": F.stats["supernodes_total"],
               "launches": got,
               "stats": None if eng is None else dict(eng.stats)}
        print("seq", json.dumps(rec), flush=True)
        if not (np.isfinite(res) and res <= RESID_TOL):
            raise AssertionError(f"{label}: residual {res:.3e}")
        if got != want_l:
            raise AssertionError(f"{label}: launches {got} != {want_l}")
        if F.stats["supernodes_on_device"] != ndev:
            raise AssertionError(f"{label}: on device "
                                 f"{F.stats['supernodes_on_device']} != {ndev}")
        if eng is not None:
            have = {k: eng.stats[k] for k in want_st}
            if have != want_st:
                raise AssertionError(f"{label}: stats {have} != {want_st}")
        out[label] = rec
        return rec

    A, sym, Ap = mats["lap3d_40"]
    b = rng.standard_normal(A.shape[0])
    t_rl, t_rlb = PAPER_THRESHOLD["rl"], PAPER_THRESHOLD["rlb"]

    def seq(method, thr, fused, bt=False, M=None):
        A_, sym_, Ap_ = M or (A, sym, Ap)
        eng = DeviceEngine(fused=fused)
        F, secs, got = run_path(fns, totals, lambda: cholesky(
            A_, method=method, schedule="seq", device_engine=eng,
            offload_threshold=thr, batch_transfers=bt, sym=sym_,
            Aperm=Ap_))
        return F, eng, secs, got

    # (a) RL, every supernode on the card, unfused: potrf/trsm_rlt/syrk_ln
    Fa, eng, secs, got = seq("rl", 0, False)
    check("a_rl_gpu_only_unfused", Fa, A, eng,
          seq_expect(sym, 0, "rl", False), secs, got, b)
    # (b) RL at the paper's 600,000, fused
    Fb, eng, secs, got = seq("rl", t_rl, True)
    check("b_rl_paper_threshold_fused", Fb, A, eng,
          seq_expect(sym, t_rl, "rl", True), secs, got, b)
    # (c) RLB at the paper's 750,000, per-block and batched transfers
    for bt in (False, True):
        F, eng, secs, got = seq("rlb", t_rlb, True, bt)
        check(f"c_rlb_paper_threshold_bt{int(bt)}", F, A, eng,
              seq_expect(sym, t_rlb, "rlb", True, bt), secs, got, b)
        if F.stats["blas_calls"] != count_blas_calls(sym):
            raise AssertionError("RLB blas_calls")
        del F
    # (d) RLB, every supernode on the card, unfused, on kkt_256
    A2, sym2, Ap2 = mats["kkt_256"]
    b2 = rng.standard_normal(A2.shape[0])
    F, eng, secs, got = seq("rlb", 0, False, M=mats["kkt_256"])
    check("d_rlb_gpu_only_unfused_kkt256", F, A2, eng,
          seq_expect(sym2, 0, "rlb", False), secs, got, b2)
    del F
    # (e) the mixed levels path at 600,000: host assembly, device batches
    eng = DeviceEngine()
    F, secs, got = run_path(fns, totals, lambda: cholesky(
        A, device_engine=eng, offload_threshold=t_rl, sym=sym, Aperm=Ap))
    sched = cached_schedule(sym)
    dev_groups = [bg for lg in sched.groups for bg in lg
                  if any(sym.size(int(s)) >= t_rl for s in bg.ids)]
    want = dict.fromkeys(KERNEL_NAMES, 0)
    want["fused_factor_syrk"] = len(dev_groups)
    n_tail = sum(1 for bg in dev_groups if bg.Lp > bg.Wp)
    check("e_levels_mixed_rl_threshold", F, A, eng,
          (want, {"transfers_in": len(dev_groups),
                  "transfers_out": len(dev_groups) + n_tail,
                  "device_calls": len(dev_groups)},
           seq_expect(sym, t_rl, "rl", True)[2]), secs, got, b)
    if F.stats["assembly"] != "host":
        raise AssertionError("mixed path did not assemble on the host")
    del F
    # (f) the host-only baseline: no device engine, numpy only
    F, secs, got = run_path(fns, totals, lambda: factorize_rl(sym, Ap))
    check("f_rl_host_only", F, A, None,
          (dict.fromkeys(KERNEL_NAMES, 0), {}, 0), secs, got, b)
    d = float(np.max(np.abs(F.store.storage - Fb.store.storage)))
    out["f_rl_host_only"]["vs_b_max_abs_diff"] = d
    del F
    # (g) device solve of (b)'s host factor: stages it, then solves
    nrhs = 64
    bb = rng.standard_normal((A.shape[0], nrhs))
    xs, secs, got = run_path(fns, totals, lambda: (
        Fb.solve(b, backend="device"), Fb.solve(bb, backend="device")))
    groups = sum(len(lg) for lg in cached_schedule(sym, bucket="batch").groups)
    res = max(residual(A, xs[0], b), residual(A, xs[1], bb))
    t0 = time.perf_counter()
    Fb.solve(b, backend="device")
    rec = {"phase": "g_device_solve_of_host_factor", "seconds": secs,
           "warm_solve1_s": time.perf_counter() - t0, "resid": res,
           "groups": groups, "launches": got}
    print("seq", json.dumps(rec), flush=True)
    out["g"] = rec
    if not res <= RESID_TOL or got["tri_inv_lower"] != groups or any(
            v for k, v in got.items() if k != "tri_inv_lower"):
        raise AssertionError(f"(g): residual {res:.3e}, launches {got}, "
                             f"{groups} groups")
    # (h) (a)'s card factor against the port's CPU run of the same call
    t0 = time.perf_counter()
    Fc = cholesky(A, method="rl", schedule="seq", offload_threshold=0,
                  device_engine=DeviceEngine(device="cpu", fused=False),
                  sym=sym, Aperm=Ap)
    d = float(np.max(np.abs(Fa.store.storage - Fc.store.storage)))
    scale = float(np.max(np.abs(Fc.store.storage)))
    rec = {"phase": "h_a_vs_cpu", "cpu_seconds": time.perf_counter() - t0,
           "max_abs_diff": d, "max_abs_L": scale}
    print("seq", json.dumps(rec), flush=True)
    out["h"] = rec
    if not d <= 1e-10 * scale:
        raise AssertionError(f"(h): card vs CPU {d:.3e} > 1e-10 * {scale:.3e}")
    del Fa, Fb, Fc
    torch.cuda.empty_cache()
    return out


def nonfinite_err(x, ref, live=None) -> tuple[float, float]:
    """``rel_err`` over the cells finite in ``ref``; raises unless ``x`` is
    nonfinite exactly where ``ref`` is (a broken lane is NaN on both).
    ``live`` restricts both to a lane's live cells (the other cells of a
    broken lane are unspecified)."""
    import torch

    if live is not None:
        x, ref = x[live], ref[live]
    fin = torch.isfinite(ref)
    if not torch.equal(torch.isfinite(x), fin):
        raise AssertionError("nonfinite cells differ from the plain version")
    if not fin.any():
        return 0.0, 0.0
    return rel_err(x[fin], ref[fin])


def capture_clamping_groups(A, sym, thr: float):
    """The group buffers of a ``guard="perturb"`` card factorization of
    ``A`` whose lanes clamp: the engine's guarded kernel calls are recorded
    (inputs cloned before the call) for this one run only."""
    import torch

    import repro_torch.core.engines as engines
    from repro_torch.core import cholesky

    seen = []
    real = engines.fused_factor_syrk

    def record(buf, rows, ws, **kw):
        saved = (buf.clone(), rows.clone(), ws.clone())
        out = real(buf, rows, ws, **kw)
        if kw.get("guard") and bool((out[2][:, 1] > 0).any()):
            seen.append(saved)
        return out

    engines.fused_factor_syrk = record
    try:
        F = cholesky(A, sym=sym, guard="perturb")
    finally:
        engines.fused_factor_syrk = real
    torch.cuda.synchronize()
    if not seen or F.guard_report.n_perturbed <= 0:
        raise AssertionError("kkt_saddle_64: no clamping group recorded")
    return seen


def guarded_kernel_phase(plan, kkt_groups, thr_lap: float, thr_kkt: float,
                         peaks):
    """The guarded fused kernel against its plain version, with the
    unguarded kernel's time on the same buffers beside it (the cost of
    detection): lap3d_40's widest group (Bp = 1, 2048 x 2048) and its most
    batched group, made as ``kernel_phase`` makes them, and the recorded
    kkt_saddle_64 groups whose lanes clamp; each at thr = 0 and at the
    matrix's perturb threshold.  fp and u at REL_TOL (NaN where the plain
    version has NaN), status counts and flags equal, min d^2 and magnitude
    at rtol 1e-10.  Each record counts the (lane, slab) pairs the check
    routed to the column sweep (``guarded_sweeps``); the launches and
    device time of a call at each thr are traced together against
    ``fused_launches``."""
    import torch

    from repro_torch.kernels.fused import (
        fused_factor_syrk,
        fused_factor_syrk_guarded,
        fused_factor_syrk_guarded_ref,
        guarded_sweeps,
        live_cells,
    )

    groups = [g for lvl in plan.groups for g in lvl]
    largest = max(groups, key=lambda g: (g.Lp * g.Wp, g.Wp))
    batched = max(groups, key=lambda g: (g.B, g.Lp * g.Wp))
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 2)
    cases = []
    for label, g in (("lap3d_40 widest", largest),
                     ("lap3d_40 most batched", batched)):
        p, rows, ws = make_group(g, True, gen)
        cases.append((label, p, rows, ws, thr_lap, fused_work(g)))
    for i, (p, rows, ws) in enumerate(kkt_groups):
        ext = dict(B=int((ws > 0).sum()), rows_arr=rows.cpu().numpy(),
                   ws_arr=ws.cpu().numpy(), gidx=p)
        work = fused_work(type("G", (), ext))
        cases.append((f"kkt_saddle_64 clamping group {i}", p, rows, ws,
                      thr_kkt, work))
    out = []
    for label, p, rows, ws, thr_p, (flops, nbytes) in cases:
        Bp, Lp, Wp = p.shape
        for thr in (0.0, thr_p):
            fp, u, st = fused_factor_syrk_guarded(p, rows, ws, thr)
            torch.cuda.synchronize()
            swept = guarded_sweeps()
            fr, ur, sr = fused_factor_syrk_guarded_ref(p, rows, ws, thr)
            afp, efp = nonfinite_err(fp, fr, live_cells(rows, ws, Lp, Wp,
                                                        p.device))
            au, eu = nonfinite_err(u, ur)
            if not (efp <= REL_TOL and eu <= REL_TOL):
                raise AssertionError(f"guarded {label} thr={thr}: rel err "
                                     f"fp {efp:.3e} u {eu:.3e}")
            if not torch.equal(st[:, 1:3], sr[:, 1:3]):
                raise AssertionError(f"guarded {label} thr={thr}: clamp "
                                     f"counts or flags differ")
            if not torch.allclose(st[:, [0, 3]], sr[:, [0, 3]], rtol=1e-10,
                                  atol=0, equal_nan=True):
                raise AssertionError(f"guarded {label} thr={thr}: min d^2 "
                                     f"or magnitude differ")
            big = Lp * Wp >= 1 << 21
            reps = 3 if big else 10
            ms = cuda_ms(lambda: fused_factor_syrk_guarded(p, rows, ws, thr),
                         reps)
            plain_ms = cuda_ms(
                lambda: fused_factor_syrk_guarded_ref(p, rows, ws, thr), 1)
            unguarded_ms = cuda_ms(lambda: fused_factor_syrk(p, rows, ws),
                                   reps)
            bound, by = work_bound(flops, nbytes, peaks)
            rec = dict(case=label, thr=thr, Bp=Bp, Lp=Lp, Wp=Wp,
                       max_abs_err=max(afp, au), rel_err=max(efp, eu),
                       n_clamped=int(st[:, 1].sum()),
                       nonfinite_lanes=int(st[:, 2].sum()),
                       swept_lane_slabs=swept,
                       lane_slabs=int(((ws.long() + min(Wp, 64) - 1)
                                       // min(Wp, 64)).sum()),
                       ms=ms, plain_ms=plain_ms, unguarded_ms=unguarded_ms,
                       library_ms=None, bound_ms=bound, bound_by=by,
                       gflop=flops / 1e9)
            out.append(rec)
        # one trace of a call at each thr (one profiler session per buffer:
        # the tracer has dropped whole sessions when given many more)
        trace = check_launches(
            f"fused_factor_syrk_guarded {label}",
            lambda: [fused_factor_syrk_guarded(p, rows, ws, t)
                     for t in (0.0, thr_p)],
            2 * fused_launches(Bp, Lp, Wp, guard=True))
        for rec in out[-2:]:
            rec.update(device_launches_per_call=(
                trace["device_launches_per_call"] // 2),
                device_ms_both_thr=trace["device_ms"])
            print("kernel fused_factor_syrk_guarded", json.dumps(rec),
                  flush=True)
        del p, fp, u, st, fr, ur, sr
        torch.cuda.empty_cache()
    return out


def clamps(rep) -> list:
    return [(q["supernode"], q["n_clamped"]) for q in rep.perturbations]


def guard_phases(mats, suite):
    """The breakdown guard through ``cholesky(guard=...)`` on the card, each
    breakdown-suite call against the port's CPU run of the same call."""
    import torch

    from repro_torch.core import BreakdownError, DeviceEngine, cholesky

    out = {}
    A, sym, Ap = mats["lap3d_40"]
    n = A.shape[0]
    b = np.random.default_rng(SEED).standard_normal(n)
    secs, engs, facs = {}, {}, {}
    for guard in ("off", "raise", "off", "raise"):  # warm, interleaved
        eng = DeviceEngine()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        F = cholesky(A, device_engine=eng, sym=sym, Aperm=Ap, guard=guard)
        secs.setdefault(guard, []).append(time.perf_counter() - t0)
        engs[guard], facs[guard] = eng, F
    rep = facs["raise"].guard_report
    tr = {g: (e.stats["transfers_in"], e.stats["transfers_out"],
              e.stats["device_calls"]) for g, e in engs.items()}
    res = residual(A, facs["raise"].solve(b, backend="device"), b)
    rec = {"phase": "guard_raise_lap3d_40", "off_s": secs["off"],
           "raise_s": secs["raise"], "min_pivot": rep.min_pivot,
           "ok": rep.ok, "resid": res, "transfers_calls": tr}
    print("guard", json.dumps(rec), flush=True)
    out["lap3d_40"] = rec
    if not (rep.ok and rep.min_pivot > 0 and not rep.perturbations
            and res <= RESID_TOL and tr["off"] == tr["raise"]):
        raise AssertionError(f"guard raise on lap3d_40: {rec}")
    del facs, engs
    torch.cuda.empty_cache()

    def both(name, guard, devs=("cuda", "cpu")):
        """(card result, CPU result): a factor or the BreakdownError."""
        A_, sym_ = suite[name]
        res_ = []
        for dev in devs:
            t0 = time.perf_counter()
            try:
                r = cholesky(A_, device=dev, sym=sym_, guard=guard)
            except BreakdownError as e:
                r = e
            torch.cuda.synchronize()
            res_.append((r, time.perf_counter() - t0))
        return res_

    (eg, tg), (ec, tc) = both("kkt_saddle_64", "raise")
    ok = (isinstance(eg, BreakdownError) and isinstance(ec, BreakdownError)
          and eg.report.first_broken == ec.report.first_broken
          and [q["supernode"] for q in eg.report.broken]
          == [q["supernode"] for q in ec.report.broken])
    rec = {"phase": "kkt_saddle_64 raise", "card_s": tg, "cpu_s": tc,
           "first_broken": getattr(getattr(eg, "report", None),
                                   "first_broken", None),
           "n_broken": len(getattr(getattr(eg, "report", None), "broken",
                                   []))}
    print("guard", json.dumps(rec), flush=True)
    out["kkt_raise"] = rec
    if not ok:
        raise AssertionError(f"kkt_saddle_64 raise: card {eg!r}, cpu {ec!r}")
    rng = np.random.default_rng(SEED + 3)
    for name, guard in (("kkt_saddle_64", "perturb"), ("neumann_64",
                        "perturb"), ("gram_400", "perturb"),
                        ("badscale_64", "raise"), ("kkt_saddle_64", "shift")):
        A_, _ = suite[name]
        # shift needs no CPU run: the CPU tests hold it to the reference
        runs = both(name, guard, ("cuda",) if guard == "shift"
                    else ("cuda", "cpu"))
        (Fg, tg), (Fc, tc) = runs[0], runs[-1]
        for F in (Fg, Fc):
            if isinstance(F, BreakdownError):
                raise AssertionError(f"{name} {guard}: {F}")
        rg, rcpu = Fg.guard_report, Fc.guard_report
        bb = (np.asarray(A_ @ rng.standard_normal(A_.shape[0]))
              if name in ("neumann_64", "gram_400")
              else rng.standard_normal(A_.shape[0]))
        t0 = time.perf_counter()
        x = Fg.solve(bb, backend="device")
        solve_s = time.perf_counter() - t0
        res = residual(A_, x, bb)
        rec = {"phase": f"{name} {guard}", "card_s": tg,
               "cpu_s": None if Fc is Fg else tc,
               "n_perturbed": rg.n_perturbed, "shift": rg.shift,
               "shifts": rg.shifts, "refined_solve_s": solve_s,
               "gmres_steps": len(rg.ir_history[-1]) if rg.ir_history else 0,
               "resid": res, "min_pivot": rg.min_pivot}
        print("guard", json.dumps(rec), flush=True)
        out[f"{name} {guard}"] = rec
        if guard == "perturb":
            good = (rg.ok and rg.n_perturbed > 0 and res <= RESID_TOL
                    and clamps(rg) == clamps(rcpu))
        elif guard == "shift":
            good = rg.ok and rg.shift > 0 and rg.shifts > 0 and \
                res <= RESID_TOL
        else:
            good = rg.ok and rcpu.ok and not rg.perturbations
        if not good:
            raise AssertionError(f"{name} {guard}: {rec}, cpu clamps "
                                 f"{clamps(rcpu)}, card {clamps(rg)}")
    return out


def many_and_plan_phases(mats):
    """``cholesky_many`` on four shifted copies of lap3d_40 (guard off and
    raise) against four ``cholesky`` calls through the same plan, its
    batched solve, and the warm plan fast path against the warm call
    without a plan."""
    import scipy.sparse as sp
    import torch

    from repro_torch.core import (
        DeviceEngine,
        PlanCache,
        cholesky,
        cholesky_many,
    )

    A, sym, Ap = mats["lap3d_40"]
    n = A.shape[0]
    out = {}
    t0 = time.perf_counter()
    plan = PlanCache().get(A)
    out["plan_build_s"] = time.perf_counter() - t0
    As = [sp.csc_matrix(A + s * sp.eye(n)) for s in (0.0, 0.5, 1.0, 2.0)]
    eng = DeviceEngine()
    cholesky(A, plan=plan, device_engine=eng)            # warm both paths
    singles, t_single = [], []
    for rep in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fs = [cholesky(Ai, plan=plan, device_engine=eng) for Ai in As]
        torch.cuda.synchronize()
        t_single.append(time.perf_counter() - t0)
        if rep == 0:
            singles = [f.store.storage for f in fs]
        del fs
    rng = np.random.default_rng(SEED + 4)
    b = rng.standard_normal((4, n, 2))
    for guard in ("off", "raise"):
        t_many = []
        for _ in range(2):
            e = DeviceEngine()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            BF = cholesky_many(As, plan=plan, device_engine=e, guard=guard)
            torch.cuda.synchronize()
            t_many.append(time.perf_counter() - t0)
        groups = BF.stats["schedule"]["batches"]
        scale = max(float(np.max(np.abs(s_))) for s_ in singles)
        diff = max(float(np.max(np.abs(BF.storage[i] - singles[i])))
                   for i in range(4))
        calls = e.stats["device_calls"]
        t0 = time.perf_counter()
        x = BF.solve(b)
        solve_s = time.perf_counter() - t0
        res = max(residual(As[i], x[i], b[i]) for i in range(4))
        rec = {"phase": f"cholesky_many M=4 guard={guard}",
               "many_s": t_many, "four_single_s": t_single,
               "speedup": min(t_single) / min(t_many),
               "device_calls": calls, "groups": groups,
               "max_abs_diff_vs_single": diff, "max_abs_L": scale,
               "solve_s": solve_s, "resid": res}
        print("many", json.dumps(rec), flush=True)
        out[guard] = rec
        if not (diff <= 1e-10 * scale and calls == groups
                and res <= RESID_TOL):
            raise AssertionError(f"cholesky_many guard={guard}: {rec}")
        if guard == "raise" and not all(r.ok for r in BF.guard_reports):
            raise AssertionError("cholesky_many raise: a report is not ok")
        del BF, x
        torch.cuda.empty_cache()
    t_plan, t_sym = [], []
    for _ in range(2):                                    # interleaved
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        F0 = cholesky(A, sym=sym, Aperm=Ap, device_engine=eng)
        torch.cuda.synchronize()
        t_sym.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        F = cholesky(A, plan=plan, device_engine=eng)
        torch.cuda.synchronize()
        t_plan.append(time.perf_counter() - t0)
    diff = float(np.max(np.abs(F.store.storage - F0.store.storage)))
    scale = float(np.max(np.abs(F0.store.storage)))
    rec = {"phase": "plan fast path lap3d_40", "plan_s": t_plan,
           "no_plan_s": t_sym, "plan_build_s": out["plan_build_s"],
           "max_abs_diff_vs_no_plan": diff}
    print("plan", json.dumps(rec), flush=True)
    out["plan"] = rec
    if not diff <= 1e-10 * scale:
        raise AssertionError(f"plan path factor differs: {rec}")
    return out


#: the serving phase's stream: two 2-D Laplacian patterns (n = 65,536 and
#: 66,049, the size of kkt_256) and batched requests of M = 4
SERVE = dict(patterns=2, grid=256, many=4, nrhs=4, seed=0)


def timed_handle(srv) -> list:
    """Time every request through ``srv.handle``: (kind, cache miss,
    seconds, ok) per request, in order."""
    import torch

    recs = []
    handle = srv.handle

    def timed(kind, *args, **kw):
        misses = srv.cache.stats["misses"]
        t0 = time.perf_counter()
        res = handle(kind, *args, **kw)
        torch.cuda.synchronize()
        recs.append((kind, srv.cache.stats["misses"] > misses,
                     time.perf_counter() - t0, res["ok"]))
        return res

    srv.handle = timed
    return recs


def check_stream(label: str, rep: dict, misses: int) -> None:
    """A clean stream: solves at the residual limit, no rebuild on a repeat
    pattern, one miss per pattern, nothing rejected, no step down."""
    bad = []
    if not rep.get("max_solve_resid", np.inf) <= RESID_TOL:
        bad.append("residual")
    if rep["repeat_rebuilds"] != 0:
        bad.append("repeat rebuilds")
    if rep["cache"]["misses"] != misses:
        bad.append("cache misses")
    if rep["rejected"] != 0 or any(rep["degraded"].values()):
        bad.append("rejected requests")
    if any(rep["fallbacks"].values()):
        bad.append("fallbacks")
    if bad:
        raise AssertionError(f"{label}: {', '.join(bad)}: {rep}")


def serving_phase(requests: int):
    """(a) The solver server at full size under ``guard="raise"``:
    ``run_stream(CholeskyServer(), synthetic_stream(...))``."""
    from repro_torch.launch.serve import (
        CholeskyServer,
        run_stream,
        synthetic_stream,
    )

    srv = CholeskyServer()
    recs = timed_handle(srv)
    reqs = synthetic_stream(requests=requests, **SERVE)
    rep = run_stream(srv, reqs, grid=SERVE["grid"], seed=SERVE["seed"])
    check_stream("serve", rep, SERVE["patterns"])

    def secs(kind, miss):
        return [t for k, m, t, _ok in recs if k == kind and m == miss]

    out = {k: rep[k] for k in ("factorizations_per_s", "solves_per_s",
                               "factorizations", "solves", "factor_s",
                               "solve_s", "requests", "cache",
                               "max_solve_resid", "engine", "fallbacks")}
    out.update(first_factor_s=secs("factor", True),
               repeat_factor_s=secs("factor", False),
               factor_many_s=secs("factor_many", False),
               solve_request_s=secs("solve", False))
    return out


def cli_phase():
    """(b) ``python -m repro_torch.launch.serve`` twice on one cache
    directory: the second process serves every pattern from disk.  Each
    process's report must show no step down a tier, no rejected request
    and a solve residual within ``RESID_TOL`` (another process's steps
    down are not in this one's ``STEPS_DOWN``)."""
    import ast
    import shutil

    cache = ROOT / "build" / "serve_cache"
    shutil.rmtree(cache, ignore_errors=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--grid", "64",
           "--patterns", "2", "--requests", "8", "--many", "2",
           "--cache-dir", str(cache)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"serve CLI failed: {proc.stderr[-2000:]}")
        lines = proc.stdout.splitlines()

        def field(tag):
            return next(ln for ln in lines if tag in ln).split(tag)[1]

        stats = field("plan cache:")
        runs.append({"seconds": time.perf_counter() - t0,
                     "cache": ast.literal_eval(
                         stats.split("repeat_rebuilds")[0].strip()),
                     "repeat_rebuilds": int(stats.split("=")[1]),
                     "fallbacks": ast.literal_eval(
                         field("fallbacks:").split("rejected")[0].strip()),
                     "rejected": int(field("rejected=")),
                     "max_solve_resid": float(field("max solve resid:")),
                     "stdout": lines})
    shutil.rmtree(cache, ignore_errors=True)
    first, second = runs[0]["cache"], runs[1]["cache"]
    if not (first["misses"] == 2 and second["misses"] == 0
            and second["disk_hits"] > 0
            and all(r["repeat_rebuilds"] == 0 and r["rejected"] == 0
                    and not any(r["fallbacks"].values())
                    and r["max_solve_resid"] <= RESID_TOL for r in runs)):
        raise AssertionError(f"serve CLI: {runs}")
    return runs


def chaos_phase():
    """(c) The scenarios of the fault tests on the card: each asserts what
    its plan fired and the exact fallbacks."""
    import scipy.sparse as sp
    import torch

    from repro_torch.core import (
        BreakdownError,
        DeviceEngine,
        cholesky,
        engines,
    )
    from repro_torch.faults import FaultPlan, make_indefinite
    from repro_torch.kernels import fused_factor_syrk_guarded
    from repro_torch.launch.serve import (
        CholeskyServer,
        run_stream,
        synthetic_stream,
    )
    from repro_torch.sparse import laplacian_2d

    out = {}
    A = laplacian_2d(16)
    b = np.ones(A.shape[0])

    def run(plan=None, host=False):
        eng = DeviceEngine()
        eng.faults = plan
        if host:  # the plain tier down too: the chain reaches the host

            def plain_down(*_a, **_k):
                raise RuntimeError("plain tier down")

            eng._device_group = plain_down
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        F = cholesky(A, device_engine=eng, guard="raise")
        torch.cuda.synchronize()
        return F, eng, time.perf_counter() - t0

    def expect(label, eng, fired, fallbacks):
        got = {"fired": eng.faults.fired, "fallbacks": eng.fallbacks}
        out[label] = got
        if got != {"fired": fired, "fallbacks": fallbacks}:
            raise AssertionError(f"chaos {label}: {got}, want fired "
                                 f"{fired} fallbacks {fallbacks}")

    F0 = run()[0]
    groups = F0.stats["schedule"]["batches"]
    scale = float(np.max(np.abs(F0.store.storage)))
    # fail_dispatch: the failed group launches no kernel, the plain tier
    # runs it, and its result is the kernel's
    n0 = fused_factor_syrk_guarded.launches
    F, eng, _ = run(FaultPlan(fail_dispatch=1))
    launched = fused_factor_syrk_guarded.launches - n0
    expect("fail_dispatch", eng, [("fail_dispatch", 1, 0)],
           {"plain": 1, "host": 0, "failed": 0})
    diff = float(np.max(np.abs(F.store.storage - F0.store.storage)))
    out["fail_dispatch"].update(guarded_launches=launched, groups=groups,
                                max_abs_diff=diff, max_abs_L=scale)
    if not (launched == groups - 1 and diff <= 1e-10 * scale
            and F.guard_report.ok and residual(A, F.solve(b), b)
            <= RESID_TOL):
        raise AssertionError(f"chaos fail_dispatch: {out['fail_dispatch']}")
    # any other error of the kernel tier is not served by the plain
    # versions: it is counted as failed and raised
    eng = DeviceEngine()
    steps = dict(engines.STEPS_DOWN)

    def refused(*_a, **_k):
        raise RuntimeError("wrapper refused the group")

    kernel, engines.fused_factor_syrk = engines.fused_factor_syrk, refused
    try:
        cholesky(A, device_engine=eng, guard="raise")
    except RuntimeError as e:
        out["kernel_error"] = {"error": str(e), "fallbacks": eng.fallbacks}
    else:
        raise AssertionError("chaos kernel_error: the error was absorbed")
    finally:
        engines.fused_factor_syrk = kernel
    if not (eng.fallbacks == {"plain": 0, "host": 0, "failed": 1}
            and engines.STEPS_DOWN == steps):
        raise AssertionError(f"chaos kernel_error: {out['kernel_error']}")
    # fail_always: every group steps down once (to the plain tier); with
    # the plain tier down too, every group reaches the host tier; five
    # rounds in turns with a clean run time a step down
    tiers = {"clean": [], "fail_always": [], "fail_always_host": []}
    last = {}
    for _ in range(5):
        tiers["clean"].append(run()[2])
        for label, host in (("fail_always", False),
                            ("fail_always_host", True)):
            plan = FaultPlan(fail_dispatch=1, fail_always=True)
            F, eng, t = run(plan, host=host)
            tiers[label].append(t)
            last[label] = (F, eng)
    for label, host in (("fail_always", False), ("fail_always_host", True)):
        F, eng = last[label]
        fired = [("fail_dispatch", i + 1, lvl) for i, lvl in enumerate(
            lvl for lvl, n in enumerate(F0.stats["level_stats"])
            for _ in range(n["batches"]))]
        expect(label, eng, fired, {"plain": groups,
                                   "host": groups if host else 0,
                                   "failed": 0})
        diff = float(np.max(np.abs(F.store.storage - F0.store.storage)))
        out[label]["max_abs_diff"] = diff
        if not diff <= 1e-10 * scale:
            raise AssertionError(f"chaos {label}: factor differs by {diff}")
        out[label]["fired"] = len(out[label]["fired"])
    # the cost of one step down, per group of this factorization
    out["step_down_s_per_group"] = {
        "plain": (min(tiers["fail_always"]) - min(tiers["clean"])) / groups,
        "host": (min(tiers["fail_always_host"]) - min(tiers["clean"]))
        / groups}
    out["tier_factor_s"] = tiers
    # silent corruption: only the in-kernel guard catches it
    for label, plan, M in (("corrupt_upload", FaultPlan(corrupt_upload=1), 16),
                           ("nan_pool", FaultPlan(nan_pool_level=0), 24)):
        eng = DeviceEngine()
        eng.faults = plan
        try:
            cholesky(laplacian_2d(M), device_engine=eng, guard="raise")
        except BreakdownError as e:
            rep = e.report
        else:
            raise AssertionError(f"chaos {label}: no BreakdownError")
        fired = ([("corrupt_upload", 1)] if label == "corrupt_upload"
                 else [("nan_pool", 0)])
        expect(label, eng, fired, {"plain": 0, "host": 0, "failed": 0})
        out[label].update(first_broken_level=rep.first_broken_level,
                          broken=len(rep.broken))
        if not (any(x["nonfinite"] for x in rep.broken)
                and (label == "corrupt_upload"
                     or rep.first_broken_level >= 1)):
            raise AssertionError(f"chaos {label}: {out[label]}")

    # the chaos stream and the perturb stream of the fault tests
    def mutate(i, A_):
        if i % 5 == 1:
            return make_indefinite(A_, i=0, value=-50.0)
        if i % 7 == 3:
            B = sp.lil_matrix(A_.copy())
            B[0, 0] = np.nan
            return B.tocsc()
        return A_

    srv = CholeskyServer(guard="raise")
    srv.engine.faults = FaultPlan(fail_dispatch=3)
    rep = run_stream(srv, synthetic_stream(requests=14, patterns=3, grid=9,
                                           many=2, seed=5),
                     grid=9, seed=5, mutate=mutate)
    expect("chaos_stream", srv.engine, srv.engine.faults.fired[:1],
           {"plain": 1, "host": 0, "failed": 0})
    deg = rep["degraded"]
    out["chaos_stream"].update(degraded=deg, rejected=rep["rejected"],
                               max_solve_resid=rep["max_solve_resid"])
    if not (srv.engine.faults.fired[0][:2] == ("fail_dispatch", 3)
            and rep["rejected"] > 0 and deg["breakdowns"] > 0
            and deg["bad_inputs"] > 0 and rep["max_solve_resid"] < 1e-8):
        raise AssertionError(f"chaos stream: {rep}")
    srv = CholeskyServer(guard="perturb")

    def indefinite(i, A_):
        return make_indefinite(A_, i=1, value=-9.0) if i == 2 else A_

    rep = run_stream(srv, synthetic_stream(requests=8, patterns=2, grid=9,
                                           many=2, seed=2),
                     grid=9, seed=2, mutate=indefinite)
    out["perturb_stream"] = {"degraded": rep["degraded"],
                             "fallbacks": rep["fallbacks"],
                             "max_solve_resid": rep["max_solve_resid"]}
    if not (rep["degraded"]["recovered"] >= 1 and rep["rejected"] == 0
            and rep["max_solve_resid"] < 1e-8
            and not any(rep["fallbacks"].values())):
        raise AssertionError(f"perturb stream: {rep}")
    return out


def verify_phase(requests: int):
    """(d) The serving stream with ``verify=True``: every new pattern's
    plan linted, every factor request's trace audited, no error."""
    from repro_torch.launch.serve import (
        CholeskyServer,
        run_stream,
        synthetic_stream,
    )

    srv = CholeskyServer(verify=True)
    rep = run_stream(srv, synthetic_stream(requests=requests, **SERVE),
                     grid=SERVE["grid"], seed=SERVE["seed"])
    check_stream("verify", rep, SERVE["patterns"])
    if "error" in rep["verify"]:
        raise AssertionError(f"verify: {rep['verify']}")
    return {"verify": rep["verify"], "findings": len(srv.verify_findings),
            "factor_s": rep["factor_s"], "requests": rep["requests"]}


def oracle_phase(mats):
    """(e) The three-dispatch oracle (``fused_groups=False``) on lap3d_40:
    three engine calls a group and one ``fused_factor_syrk`` launch a group
    on either bucket family.  On the one-dispatch path's own ``"fused"``
    family its panels equal the one-dispatch factor bit for bit.  On the
    reference's fine ``"batch"`` family (the oracle's default) the two
    group the prefix sums differently, so they are held to the rounding of
    those sums: a cell's ``C[hi] - C[lo]`` rounds at the scale of the
    running totals, at most 2u max|C| on each side (u = 2^-53), and a
    panel entry moves by no more than its cell (every pivot of lap3d_40 is
    above 4), so ``|L_batch - L_fused| <= 4u (P_batch + P_fused)`` with P
    each oracle's ``scan_peak``: a first-order bound, which ignores growth
    through later levels.  The reference's 1e-12 ``allclose`` is
    reported beside it."""
    import torch

    from repro_torch.core import DeviceEngine, cholesky
    from repro_torch.core.numeric import _factorize_levels_device
    from repro_torch.kernels import fused_factor_syrk

    A, sym, Ap = mats["lap3d_40"]
    eng1 = DeviceEngine()
    F1 = cholesky(A, sym=sym, Aperm=Ap, device_engine=eng1)
    b = np.random.default_rng(SEED).standard_normal(A.shape[0])
    rec, peaks, bad = {}, {}, []
    for family in ("batch", "fused"):
        eng3 = DeviceEngine(fused_groups=False)
        n0 = fused_factor_syrk.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        F3 = _factorize_levels_device(
            sym, Ap, eng3, bucket=None if family == "batch" else family)
        t3 = time.perf_counter() - t0
        launched = fused_factor_syrk.launches - n0
        stats = dict(eng3.stats)
        batches = F3.stats["schedule"]["batches"]
        peaks[family] = float(eng3.scan_peak)
        diff = max(float(np.max(np.abs(p3 - p1)))
                   for p3, p1 in zip(F3.panels, F1.panels))
        # np.testing.assert_allclose(rtol=1e-12, atol=1e-12), as a ratio
        ratio = max(float(np.max(np.abs(p3 - p1)
                                 / (1e-12 + 1e-12 * np.abs(p1))))
                    for p3, p1 in zip(F3.panels, F1.panels))
        res = residual(A, F3.solve(b, backend="device"), b)
        rec[family] = {"bucket": F3.stats["bucket"], "batches": batches,
                       "factor_stats": stats,
                       "fused_launches": launched, "factor_s": t3,
                       "max_abs_diff": diff, "allclose_1e12_ratio": ratio,
                       "scan_peak": peaks[family], "resid": res}
        if not (F3.stats["bucket"] == family
                and stats["device_calls"] == 3 * batches
                and launched == batches and res <= RESID_TOL):
            bad.append(family)
        del F3
    tol = 4 * 2.0 ** -53 * (peaks["batch"] + peaks["fused"])
    rec["batch"].update(bound=tol,
                        bound_ratio=rec["batch"]["max_abs_diff"] / tol)
    rec["one_dispatch_calls"] = eng1.stats["device_calls"]
    if (bad or rec["batch"]["max_abs_diff"] > tol
            or rec["fused"]["max_abs_diff"] != 0.0
            or eng1.stats["device_calls"] != rec["fused"]["batches"]):
        raise AssertionError(f"three-dispatch oracle: {rec}")
    return rec


def entry_name(line: str) -> str:
    """The last name of the mangled entry function in a ptxas or SASS line
    (``_ZN<len><namespace><len><name>E...`` gives ``name``), with its
    integer or bool template arguments (``...ILb1EE...`` gives
    ``name<true>``)."""
    found = re.search(r"_ZN(\w+)", line)
    rest, name = found.group(1) if found else "", "?"
    while rest[:1].isdigit():
        digits = re.match(r"\d+", rest).group()
        n = int(digits)
        name, rest = rest[len(digits):len(digits) + n], rest[len(digits) + n:]
    targs = re.match(r"I((?:L[a-z]+-?\d+E)+)E", rest)
    if targs:
        args = [{"b0": "false", "b1": "true"}.get(t + v, v) for t, v in
                re.findall(r"L([a-z]+)(-?\d+)E", targs.group(1))]
        name += "<" + ", ".join(args) + ">"
    return name


def sass_dmma(build, names, must=()) -> dict:
    """The fp64 tensor-core instructions (DMMA.*) in each built library's
    SASS by function, from ``cuobjdump -sass`` beside ``nvcc``; raises if a
    library, or a function named in ``must``, holds none (the DMMA kernels
    must not have fallen back to FMAs)."""
    tool = Path(build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {"cuobjdump": "not found"}
    out = {}
    for name in names:
        sass = subprocess.run(
            [str(tool), "-sass", str(build.library_path(name))],
            capture_output=True, text=True, check=True, timeout=300).stdout
        fns: dict = {}
        for part in re.split(r"\n\s*Function : ", sass)[1:]:
            ops: dict = {}
            for op in re.findall(r"\bDMMA\.[\w.]+", part):
                ops[op] = ops.get(op, 0) + 1
            if ops:
                fns[entry_name(part.split("\n", 1)[0])] = ops
        if not fns:
            raise AssertionError(f"no DMMA instruction in {name}'s SASS")
        out[name] = fns
    for fn in must:
        if not any(fn in fns for fns in out.values()):
            raise AssertionError(f"no DMMA instruction in {fn}'s SASS")
    return out


def main() -> None:
    smi, kind, peaks = card_info()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.core import (
        cached_schedule,
        cholesky,
        device_plan,
        engines,
        perturb_threshold,
    )
    from repro_torch.core.api import symbolic_pipeline
    from repro_torch.kernels import KERNELS, _build
    from repro_torch.sparse import make_suite_matrix
    from repro_torch.sparse.gen import BREAKDOWN_SUITE

    fns = {f.__name__: f for f in KERNELS}
    assert tuple(fns) == KERNEL_NAMES, tuple(fns)
    t0 = time.perf_counter()
    secs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})",
          flush=True)
    for name in _build.SIGNATURES:
        log = _build.library_path(name).with_suffix(".so.log")
        if log.exists():
            kernel = "?"
            for line in log.read_text().splitlines():
                if "Compiling entry function" in line:
                    kernel = entry_name(line)
                elif "registers" in line or "spill" in line:
                    print(f"ptxas {name} {kernel}: {line.strip()}")
    print("sass", json.dumps(sass_dmma(_build, (
        "gemm_nt", "fused_factor_syrk", "tri_inv", "trsm_rlt", "chol_tile",
        "syrk_ln"), must=("panel_kernel<false>", "panel_kernel<true>"))),
        flush=True)

    mats = {}
    for name in ("lap3d_40", "kkt_256"):
        t0 = time.perf_counter()
        A = make_suite_matrix(name)
        sym, Aperm = symbolic_pipeline(A)
        mats[name] = (A, sym, Aperm)
        print(f"{name}: n {A.shape[0]}, symbolic {time.perf_counter() - t0:.1f}"
              f" s, {sym.nsuper} supernodes, {sym.factor_nnz()} factor cells",
              flush=True)
    A, sym, Aperm = mats["lap3d_40"]
    plan = device_plan(sym, cached_schedule(sym, bucket="fused"))
    kres = kernel_phase(plan, peaks)
    for name, recs in seq_kernel_phase(sym, peaks).items():
        kres.setdefault(name, []).extend(recs)
    suite = {}
    for name in BREAKDOWN_SUITE:
        As = make_suite_matrix(name)
        suite[name] = (As, symbolic_pipeline(As)[0])
    thr = {name: perturb_threshold(float(np.max(np.abs(M.diagonal()))))
           for name, M in (("lap3d_40", A),
                           ("kkt_saddle_64", suite["kkt_saddle_64"][0]))}
    kkt_groups = capture_clamping_groups(*suite["kkt_saddle_64"],
                                         thr["kkt_saddle_64"])
    kres["fused_factor_syrk_guarded"] = guarded_kernel_phase(
        plan, kkt_groups, thr["lap3d_40"], thr["kkt_saddle_64"], peaks)
    del kkt_groups

    totals = dict.fromkeys(KERNEL_NAMES, 0)

    def launches_of():
        return {k: f.launches for k, f in fns.items()}

    # the levels main path: the counters start from 0 here
    def levels_path():
        outs = {}
        for name in ("lap3d_40", "kkt_256"):
            A, sym, Aperm = mats[name]
            F, out = main_path(name, sym, Aperm, A, launches_of)
            outs[name] = out
            if name == "kkt_256":
                Fc = cholesky(A, device="cpu", sym=sym, Aperm=Aperm)
                d = float(np.max(np.abs(F.store.storage - Fc.store.storage)))
                scale = float(np.max(np.abs(Fc.store.storage)))
                out["cpu_max_abs_diff"] = d
                out["cpu_max_abs_L"] = scale
                if not d <= 1e-10 * scale:
                    raise AssertionError(f"kkt_256: card vs CPU factor "
                                         f"{d:.3e} > 1e-10 * {scale:.3e}")
            print("main", json.dumps(out), flush=True)
            del F
            torch.cuda.empty_cache()
        return outs

    _, secs, counts = run_path(fns, totals, levels_path)
    print(f"levels path launches: {counts} ({secs:.1f} s)", flush=True)
    if not (counts["fused_factor_syrk"] > 0 and counts["tri_inv_lower"] > 0):
        raise AssertionError(f"a kernel of the levels path was not launched: "
                             f"{counts}")
    seq_phases(mats, fns, totals)
    _, secs, counts = run_path(fns, totals, lambda: guard_phases(mats, suite))
    print(f"guard path launches: {counts} ({secs:.1f} s)", flush=True)
    if not (counts["fused_factor_syrk_guarded"] > 0
            and counts["tri_inv_lower"] > 0):
        raise AssertionError(f"a kernel of the guard path was not launched: "
                             f"{counts}")
    _, secs, counts = run_path(fns, totals, lambda: many_and_plan_phases(mats))
    print(f"multi-matrix and plan path launches: {counts} ({secs:.1f} s)",
          flush=True)
    if not (counts["fused_factor_syrk"] > 0
            and counts["fused_factor_syrk_guarded"] > 0):
        raise AssertionError(f"a kernel of the multi-matrix path was not "
                             f"launched: {counts}")
    # the solver server and what it stands on
    rec, secs, counts = run_path(fns, totals, lambda: serving_phase(16))
    print("serve", json.dumps(rec), flush=True)
    print(f"(a) serve path launches: {counts} ({secs:.1f} s)", flush=True)
    if not (counts["fused_factor_syrk_guarded"] > 0
            and counts["tri_inv_lower"] > 0):
        raise AssertionError(f"a kernel of the serve path was not launched: "
                             f"{counts}")
    rec, secs, _ = run_path(fns, totals, cli_phase)
    print("cli", json.dumps(rec), flush=True)
    print(f"(b) serve CLI twice ({secs:.1f} s)", flush=True)
    rec, secs, counts = run_path(fns, totals, chaos_phase, steps_down=True)
    print("chaos", json.dumps(rec), flush=True)
    print(f"(c) chaos launches: {counts}, steps down {engines.STEPS_DOWN} "
          f"({secs:.1f} s)", flush=True)
    if not (engines.STEPS_DOWN["plain"] > 0
            and engines.STEPS_DOWN["host"] > 0):
        raise AssertionError(f"chaos: no step down {engines.STEPS_DOWN}")
    rec, secs, counts = run_path(fns, totals, lambda: verify_phase(6))
    print("verify", json.dumps(rec), flush=True)
    print(f"(d) verify launches: {counts} ({secs:.1f} s)", flush=True)
    rec, secs, counts = run_path(fns, totals, lambda: oracle_phase(mats))
    print("oracle", json.dumps(rec), flush=True)
    print(f"(e) three-dispatch oracle launches: {counts} ({secs:.1f} s)",
          flush=True)
    print(f"launches over all paths: {totals}", flush=True)
    if min(totals.values()) <= 0:
        raise AssertionError(f"a kernel was never launched: {totals}")

    src = {
        "fused_factor_syrk": ("fused_factor_syrk.cu", "fused.py:251"),
        "tri_inv_lower": ("tri_inv.cu", "trsm.py:67"),
        "trsm_rlt": ("trsm_rlt.cu", "trsm.py:67"),
        "chol_tile": ("chol_tile.cu", "potrf.py:51"),
        "syrk_ln": ("syrk_ln.cu", "syrk.py:42"),
        "gemm_nt": ("gemm_nt.cu", "gemm.py:32"),
        "fused_factor_syrk_guarded": ("fused_factor_syrk.cu", "fused.py:251"),
    }
    design = {  # every kernel on fp64 tensor cores (the guarded repair aside)
        "fused_factor_syrk": "redesigned: one panel launch per 64-column "
        "slab (blocked 8-wide factor and doubling inverse of the diagonal "
        "block in shared memory, A21 L11^-T on DMMA) + DMMA trailing "
        "update and SYRK (mma.sync m16n8k8 f64)",
        "gemm_nt": "redesigned: DMMA tile (mma.sync m16n8k8 f64, 8 warps, "
        "cp.async 3-stage ring of 32-deep K chunks)",
        "fused_factor_syrk_guarded": "redesigned: per slab the DMMA panel "
        "launch, unclamped, keeping pivots, column maxima and a copy; a "
        "check per lane (finite, positive, 1e-8 and rounding-slack margins "
        "above thr and the growth floor) that lets the speculative slab "
        "stand or restores it and sweeps it column by column; then the "
        "DMMA trailing update and SYRK",
        "tri_inv_lower": "redesigned: 64-wide diagonal blocks inverted in "
        "shared memory (8x8 substitution + DMMA doubling), then recursive "
        "doubling over block sizes, two DMMA tile launches a level (T = "
        "L21 X11, X21 = -X22 T), 1 + 2 ceil(log2(Wp/64)) launches",
        "trsm_rlt": "redesigned: one launch; 16-row blocks sweep the "
        "64-wide block columns, each D_j inverted in shared memory (DMMA "
        "doubling), T = B_j - X L_j^T and X_j = T D_j^-T on DMMA",
        "chol_tile": "redesigned: one block, the tile padded to 8/16/32/"
        "64/128 in shared memory, blocked 8-wide right-looking factor (a "
        "warp's rsqrt 8x8 factor and inverse with look-ahead, rows below "
        "and trailing update as DMMA fragments), ceil(n/8)-1 steps",
        "syrk_ln": "redesigned: triangular grid of 64x64 DMMA tiles "
        "(dmma_tile_nt), each lower tile zeroing its mirror; subtract form "
        "in place for potrf's trailing update",
    }
    kernels = []
    for name in KERNEL_NAMES:
        recs = kres[name]
        big = recs[0]
        kernels.append({
            "name": name, "route": "cuda", "design": design[name],
            "source": "src/repro_torch/kernels/csrc/" + src[name][0],
            "replaces": "src/repro/kernels/" + src[name][1],
            "launches": totals[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": big["ms"], "plain_ms": big["plain_ms"],
            "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
            "library_ms": big["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

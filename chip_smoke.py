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
   cells); ``potrf`` (with ``chol_tile``), ``trsm_rlt``, ``syrk_ln``,
   ``gemm_nt`` and the one-panel ``fused_factor_syrk`` at the shapes the
   sequential path gives them on ``lap3d_40`` (its widest supernode, its
   largest tail, that tail's largest RLB block pair and one small 64 x 64
   pair); every fused call's kernel launches, counted by
   ``torch.profiler``, against the slab formula;
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
   the unguarded kernel's time on the same buffers;
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
9. prints a ``kernels`` JSON line, the card's name and power limit, and the
   result line ``{"ok": true, "device": {...}}`` last.

numpy's BLAS runs one thread here unless ``OPENBLAS_NUM_THREADS`` is set.

Every path runs with the kernels' launch counters set to 0 just before it
and read just after.  Any failed check raises, so the script exits non-zero
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
    ``csrc/fused_factor_syrk.cu``: the mask pass (and, guarded, the status
    init), per 64-column slab the panel launch (guarded: the sweep) and,
    while real columns remain right of the slab, the trailing launch, then
    the SYRK when Lp > Wp.  The memset of ``u`` is not a kernel."""
    nb = min(Wp, 64)
    n = 2 if guard else 1
    for k0 in range(0, Wp, nb):
        n += 1 + (Wp > k0 + nb)
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
    """Each kernel against its plain version on three groups of lap3d_40."""
    import torch

    from repro_torch.kernels.fused import (
        _mask,
        fused_factor_syrk,
        fused_factor_syrk_ref,
    )
    from repro_torch.kernels.trsm import tri_inv_lower, tri_inv_lower_ref

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

        L = fp[:, :Wp, :].contiguous()
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
        flops = sum(float(w) ** 3 / 3 for w in g.ws_arr[:g.B])
        # the lower triangle of each input lane read, the whole output written
        nbytes = 8.0 * Bp * (Wp * (Wp + 1) / 2 + Wp * Wp)
        bound = max(flops / peaks[0], nbytes / peaks[1]) * 1e3
        rec = dict(case=label, Bp=Bp, B=g.B, Wp=Wp, max_abs_err=ax,
                   rel_err=ex, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=bound,
                   bound_by="operations" if flops / peaks[0]
                   >= nbytes / peaks[1] else "bytes", gflop=flops / 1e9)
        results["tri_inv_lower"].append(rec)
        print("kernel tri_inv_lower", json.dumps(rec), flush=True)
        del p, fp, u, fr, ur, a, D, S, B, L, X, Xr
        torch.cuda.empty_cache()
    return results


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
        trsm_rlt,
        trsm_rlt_ref,
    )

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
    n = 128
    A = spd_lower(n)
    S = sym_of(A)
    cases.append(("chol_tile", f"potrf tile n={n}",
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
    T = 0.5 * randn(m, w)
    cases.append(("syrk_ln", f"tail M={m} K={w}", lambda: syrk_ln(T),
                  lambda: syrk_ln_ref(T), lambda: torch.tril(T @ T.mT),
                  float(m) * m * w, 8.0 * (m * w + m * m)))
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
        elif name == "gemm_nt":  # small calls: the wall time is the host's
            rec.update(check_launches(f"gemm_nt {label}", fn, 1))
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
    if not np.array_equal(F2.store.storage, F.store.storage):
        out["refactor_max_abs_diff"] = float(
            np.max(np.abs(F2.store.storage - F.store.storage)))
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
    (potrf: one chol_tile per NB = 128 columns and tri_inv_lower, gemm_nt,
    syrk_ln per step below the last; trsm_rlt with its tri_inv_lower per
    tail; RL one syrk_tail, RLB one syrk_ln per block and one gemm_nt per
    block pair)."""
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
            for k in ("tri_inv_lower", "gemm_nt", "syrk_ln"):
                launches[k] += steps - 1
            if m:
                launches["trsm_rlt"] += 1
                launches["tri_inv_lower"] += 1
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


def run_path(fns: dict, totals: dict, fn):
    """Run one path with every launch counter at 0 just before it; return
    (result, wall seconds, launches), adding the launches to ``totals``."""
    import torch

    for f in fns.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = {k: f.launches for k, f in fns.items()}
    for k, v in got.items():
        totals[k] += v
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
    at rtol 1e-10.  The launches and device time are traced once per
    buffer, at thr = 0 (the launches do not depend on thr)."""
    import torch

    from repro_torch.kernels.fused import (
        fused_factor_syrk,
        fused_factor_syrk_guarded,
        fused_factor_syrk_guarded_ref,
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
                       nonfinite_lanes=int(st[:, 2].sum()), ms=ms,
                       plain_ms=plain_ms, unguarded_ms=unguarded_ms,
                       library_ms=None, bound_ms=bound, bound_by=by,
                       gflop=flops / 1e9)
            if thr == 0.0:  # the launches do not depend on thr
                trace = check_launches(
                    f"fused_factor_syrk_guarded {label}",
                    lambda: fused_factor_syrk_guarded(p, rows, ws, 0.0),
                    fused_launches(Bp, Lp, Wp, guard=True))
            rec.update(trace)
            out.append(rec)
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



def entry_name(line: str) -> str:
    """The last name of the mangled entry function in a ptxas line
    (``_ZN<len><namespace><len><name>E...`` gives ``name``)."""
    found = re.search(r"_ZN(\w+)", line)
    rest, name = found.group(1) if found else "", "?"
    while rest[:1].isdigit():
        digits = re.match(r"\d+", rest).group()
        n = int(digits)
        name, rest = rest[len(digits):len(digits) + n], rest[len(digits) + n:]
    return name


def sass_dmma(build, names) -> dict:
    """The fp64 tensor-core instructions (DMMA.*) in each built library's
    SASS, from ``cuobjdump -sass`` beside ``nvcc``; raises if a library
    holds none (the DMMA kernels must not have fallen back to FMAs)."""
    tool = Path(build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {"cuobjdump": "not found"}
    out = {}
    for name in names:
        sass = subprocess.run(
            [str(tool), "-sass", str(build.library_path(name))],
            capture_output=True, text=True, check=True, timeout=300).stdout
        ops: dict = {}
        for op in re.findall(r"\bDMMA\.[\w.]+", sass):
            ops[op] = ops.get(op, 0) + 1
        if not ops:
            raise AssertionError(f"no DMMA instruction in {name}'s SASS")
        out[name] = ops
    return out


def main() -> None:
    smi, kind, peaks = card_info()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.core import (
        cached_schedule,
        cholesky,
        device_plan,
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
    print("sass", json.dumps(sass_dmma(_build, ("gemm_nt",
                                                "fused_factor_syrk"))),
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
    design = {  # the two redesigned on fp64 tensor cores, the first versions
        "fused_factor_syrk": "redesigned: one panel launch per 64-column "
        "slab (blocked 8-wide factor and doubling inverse of the diagonal "
        "block in shared memory, A21 L11^-T on DMMA) + DMMA trailing "
        "update and SYRK (mma.sync m16n8k8 f64)",
        "gemm_nt": "redesigned: DMMA tile (mma.sync m16n8k8 f64, 8 warps, "
        "cp.async 3-stage ring of 32-deep K chunks)",
        "fused_factor_syrk_guarded": "one-block column sweep per slab + "
        "the DMMA trailing update and SYRK",
        "tri_inv_lower": "first version: scalar FMA",
        "trsm_rlt": "first version: scalar FMA tile",
        "chol_tile": "first version: one-block column sweep",
        "syrk_ln": "first version: scalar FMA tile",
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

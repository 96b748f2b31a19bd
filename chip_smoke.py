#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card:

    python3 chip_smoke.py

1. card info from ``nvidia-smi`` (fails without a CUDA card);
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together, into ``build/kernels/``);
3. holds each kernel against its plain PyTorch version on group buffers at
   the shapes of ``lap3d_40``'s fused schedule (the largest group, a
   tail-heavy group, and a group with pad lanes and garbage pad cells), and
   times kernel, plain version and a library yardstick;
4. drives the main path — ``cholesky(A)`` then
   ``F.solve(b, backend="device")`` with 1 and 64 right-hand sides — on
   ``lap3d_40`` and ``kkt_256`` with the kernels' launch counters set to 0
   just before, and checks residuals, dispatch and transfer counts, the
   upload-before-dispatch order, the launch counts, and (kkt_256) the card's
   factor against the port's own CPU run;
5. prints a ``kernels`` JSON line, the card's name and power limit, and the
   result line ``{"ok": true, "device": {...}}`` last.

Any failed check raises, so the script exits non-zero and prints no result
line.  It imports nothing of JAX or of the reference package ``repro``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
REL_TOL = 1e-10     # kernel vs plain version, relative to max |plain|
RESID_TOL = 1e-10   # ||A x - b|| / ||b||

#: (fp64 tensor-core FLOP/s, device memory bytes/s) from NVIDIA's data sheets
PEAKS = {"sxm": (67e12, 3.35e12), "pcie": (51e12, 2.0e12)}


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
    dev = torch.device("cuda")
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


def main() -> None:
    smi, kind, peaks = card_info()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.core import cached_schedule, cholesky, device_plan
    from repro_torch.core.api import symbolic_pipeline
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused import fused_factor_syrk
    from repro_torch.kernels.trsm import tri_inv_lower
    from repro_torch.sparse import make_suite_matrix

    t0 = time.perf_counter()
    secs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})",
          flush=True)
    for name in _build.SIGNATURES:
        log = _build.library_path(name).with_suffix(".so.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {name}: {line.strip()}")

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

    def launches_of():
        return {"fused_factor_syrk": fused_factor_syrk.launches,
                "tri_inv_lower": tri_inv_lower.launches}

    # main path: the counters start from 0 here
    fused_factor_syrk.launches = 0
    tri_inv_lower.launches = 0
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
                raise AssertionError(f"kkt_256: card vs CPU factor {d:.3e} "
                                     f"> 1e-10 * {scale:.3e}")
        print("main", json.dumps(out), flush=True)
        del F
        torch.cuda.empty_cache()
    counts = launches_of()
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel was not launched on the main path: "
                             f"{counts}")
    print(f"main path launches: {counts}")

    src = {"fused_factor_syrk": ("src/repro_torch/kernels/csrc/"
                                 "fused_factor_syrk.cu",
                                 "src/repro/kernels/fused.py:251"),
           "tri_inv_lower": ("src/repro_torch/kernels/csrc/tri_inv.cu",
                             "src/repro/kernels/trsm.py:67")}
    kernels = []
    for name, recs in kres.items():
        big = recs[0]
        kernels.append({
            "name": name, "route": "cuda", "source": src[name][0],
            "replaces": src[name][1], "launches": counts[name],
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

"""Quickstart for the PyTorch/CUDA port (``repro_torch``): factor a sparse
SPD system with the paper's RL/RLB variants, on the host and with the card,
and solve it; then repeat patterns, multi-matrix batches, the static
analysis and the breakdown guard.  The counterpart of
``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py            # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --grid 8

``--device cpu`` runs the kernels' plain PyTorch versions on the host.
"""
import argparse
import time

import numpy as np
import scipy.sparse as sp

from repro_torch.analyze import analyze_matrix
from repro_torch.core import (
    BreakdownError,
    DeviceEngine,
    PlanCache,
    cholesky,
    cholesky_many,
    count_blocks,
    counters,
    symbolic_pipeline,
)
from repro_torch.sparse import laplacian_2d, laplacian_3d
from repro_torch.sparse.gen import kkt_saddle

#: a threshold (rows * w) above every supernode: the whole factorization
#: stays in numpy
HOST_ONLY = 10 ** 18


def resid(A, x, b) -> float:
    return float(np.linalg.norm(A @ x - b) / np.linalg.norm(b))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--grid", type=int, default=24,
                    help="the 3-D Poisson problem's grid (n = grid^3)")
    args = ap.parse_args(argv)
    dev = args.device

    A = laplacian_3d(args.grid)
    n = A.shape[0]
    b = np.sin(np.arange(n) * 0.01)

    # one symbolic analysis (ordering -> etree -> supernodes -> merge ->
    # refinement), shared by every numeric variant
    t0 = time.time()
    sym, Aperm = symbolic_pipeline(A)
    print(f"symbolic: {time.time() - t0:.2f}s  n={n}  "
          f"supernodes={sym.nsuper}  factor cells="
          f"{sym.factor_nnz() / 1e6:.1f}M  RLB blocks={count_blocks(sym)}")

    # host-only RL (the paper's baseline)
    t0 = time.time()
    F = cholesky(A, method="rl", schedule="seq", sym=sym, Aperm=Aperm,
                 device=dev, offload_threshold=HOST_ONLY)
    t_rl = time.time() - t0
    print(f"RL  (host)    {t_rl:6.2f}s  resid={resid(A, F.solve(b), b):.2e}")

    # RL with large supernodes offloaded (the paper's method, one supernode
    # at a time)
    eng = DeviceEngine(device=dev)
    kw = dict(method="rl", schedule="seq", sym=sym, Aperm=Aperm,
              device_engine=eng, offload_threshold=20_000)
    cholesky(A, **kw)  # warm
    t0 = time.time()
    F = cholesky(A, **kw)
    t_off = time.time() - t0
    print(f"RL  (offload) {t_off:6.2f}s  resid={resid(A, F.solve(b), b):.2e}"
          f"  supernodes on device: {F.stats['supernodes_on_device']}/"
          f"{F.stats['supernodes_total']}")

    # device-resident level scheduling: each (level x bucket) group is one
    # dispatch of the fused kernel; the factor comes back in one read-back
    eng2 = DeviceEngine(device=dev)
    cholesky(A, sym=sym, Aperm=Aperm, device_engine=eng2)  # warm
    eng2.stats = {k: 0 for k in eng2.stats}
    eng2.events.clear()
    t0 = time.time()
    F = cholesky(A, sym=sym, Aperm=Aperm, device_engine=eng2)
    t_lvl = time.time() - t0
    print(f"RL  (device)  {t_lvl:6.2f}s  resid={resid(A, F.solve(b), b):.2e}"
          f"  levels={F.stats['schedule']['levels']}  "
          f"batches={F.stats['schedule']['batches']}  "
          f"dispatches={eng2.stats['device_calls']}  "
          f"transfers_in={eng2.stats['transfers_in']} "
          f"(seq would be {sym.nsuper})")

    # the factor is resident, so the solve runs there too: level-scheduled
    # batched substitution
    B = np.sin(np.arange(n)[:, None] * 0.01 + np.arange(64)[None, :])
    t0 = time.time()
    X = F.solve(B)
    t_host = time.time() - t0
    F.solve(B, backend="device")  # warm
    t0 = time.time()
    X_dev = F.solve(B, backend="device")
    t_dev = time.time() - t0
    print(f"solve 64 RHS  host {t_host:6.2f}s  device {t_dev:6.2f}s  "
          f"max|dx|={np.abs(X - X_dev).max():.2e}")

    # RLB: blocked updates, no update-matrix storage
    t0 = time.time()
    F = cholesky(A, method="rlb", schedule="seq", sym=sym, Aperm=Aperm,
                 device=dev, offload_threshold=HOST_ONLY)
    print(f"RLB (host)    {time.time() - t0:6.2f}s  "
          f"blas_calls={F.stats['blas_calls']}")
    print(f"logdet(A) = {F.logdet():.4f}")

    # repeat patterns: a PlanCache keeps everything the analysis produced
    cache = PlanCache()
    cache.get(A)
    A2 = sp.csc_matrix(A + 2.0 * sp.eye(n))  # same pattern, new values
    before = counters.snapshot()
    t0 = time.time()
    F2 = cholesky(A2, plan=cache.get(A2), device_engine=eng2)
    t_rep = time.time() - t0
    x = F2.solve(b, backend="device")
    print(f"repeat pattern {t_rep:5.2f}s  rebuilds="
          f"{counters.delta(before) or 0}  cache={cache.stats}  "
          f"resid={resid(A2, x, b):.2e}")

    # a family of matrices sharing one pattern factors as ONE batch
    M = 8
    Au = laplacian_2d(max(args.grid, 8))
    nu = Au.shape[0]
    plan_u = cache.get(Au)
    As = [sp.csc_matrix(Au + (1.0 + 0.5 * i) * sp.eye(nu)) for i in range(M)]
    cholesky_many(As, plan=plan_u, device_engine=eng2)  # warm
    t0 = time.time()
    FB = cholesky_many(As, plan=plan_u, device_engine=eng2)
    t_many = time.time() - t0
    bu = np.sin(np.arange(nu) * 0.1)
    Bm = np.stack([bu[:, None] * (i + 1.0) for i in range(M)])
    Xm = FB.solve(Bm)
    r = max(resid(As[i], Xm[i], Bm[i]) for i in range(M))
    print(f"cholesky_many M={M} n={nu}  {t_many:5.3f}s  "
          f"batched-solve resid={r:.2e}")

    # static analysis: the plan stack checked without factoring
    # (python -m repro_torch.analyze --all-generators --strict)
    report = analyze_matrix(Au, name="quickstart", families=("batch", "fused"))
    print(f"analyze: {report.status()} — {len(report.errors)} errors, "
          f"{len(report.warnings)} warnings over "
          f"{len(report.metrics['families'])} bucket families")

    # breakdown safety: detect, or perturb and refine
    K = kkt_saddle(16)                     # saddle-point KKT: indefinite
    eng3 = DeviceEngine(device=dev)
    try:
        cholesky(K, device_engine=eng3, guard="raise")
    except BreakdownError as e:
        print(f"guard=raise: {e}")
    F = cholesky(K, device_engine=eng3, guard="perturb")
    bk = np.ones(K.shape[0])
    xk = F.solve(bk)                       # refined against K
    print(f"guard=perturb: {F.guard_report.n_perturbed} supernodes "
          f"perturbed, refined resid={resid(K, xk, bk):.2e}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Whether the port's levels factorization repeats bit for bit on the card,
and how far the three-dispatch oracle lands from the one-dispatch path on
each bucket family:

    python3 determinism_probe.py

Prints JSON lines:

* ``cumsum``: for fp64 rows of 10^4, 10^6 and 2 * 10^7 entries, how many
  of 20 calls of ``torch.cumsum`` and of ``engines.ordered_cumsum`` (the
  group assembly's prefix sums) differ from the first call, and the
  largest difference;
* ``refactor``: two warm factorizations of ``lap3d_40``, equal or not;
* ``oracle``: ``DeviceEngine(fused_groups=False)`` on ``lap3d_40`` against
  the one-dispatch factor, on the "fused" family (the one-dispatch path's)
  and on the fine "batch" family (the oracle's default, the reference's),
  as the largest ``|a - b| / (1e-12 + 1e-12 |b|)``
  (``np.testing.assert_allclose`` at rtol = atol = 1e-12 holds where it is
  at most 1), the largest absolute difference, and each oracle's
  ``scan_peak`` (the largest running total of its prefix sums).

Needs a CUDA card; imports the port from ``src``.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def main() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.core import DeviceEngine, cholesky, symbolic_pipeline
    from repro_torch.core.engines import ordered_cumsum
    from repro_torch.core.numeric import _factorize_levels_device
    from repro_torch.sparse import make_suite_matrix

    if not torch.cuda.is_available():
        raise SystemExit("determinism_probe: needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for n in (10_000, 1_000_000, 20_000_000):
        x = torch.randn(1, n, dtype=torch.float64, device=dev,
                        generator=gen) ** 2
        rec = {"n": n}
        for name, fn in (("torch.cumsum", lambda: torch.cumsum(x, 1)),
                         ("ordered_cumsum", lambda: ordered_cumsum(x))):
            first = fn()
            runs = [fn() for _ in range(20)]
            rec[name] = {
                "differ": sum(not torch.equal(r, first) for r in runs),
                "max_diff": max(float((r - first).abs().max())
                                for r in runs)}
        print("cumsum", json.dumps(rec), flush=True)

    A = make_suite_matrix("lap3d_40")
    sym, Ap = symbolic_pipeline(A)
    F1 = cholesky(A, sym=sym, Aperm=Ap, device_engine=DeviceEngine())
    F2 = cholesky(A, sym=sym, Aperm=Ap, device_engine=DeviceEngine())
    print("refactor", json.dumps({
        "equal": bool(np.array_equal(F1.store.storage, F2.store.storage)),
        "max_diff": float(np.max(np.abs(F1.store.storage
                                        - F2.store.storage)))}),
        flush=True)
    for family in ("fused", "batch"):
        eng = DeviceEngine(fused_groups=False)
        F3 = _factorize_levels_device(sym, Ap, eng, bucket=family)
        ratio = max(float(np.max(np.abs(p - q) / (1e-12 + 1e-12 * np.abs(q))))
                    for p, q in zip(F3.panels, F1.panels))
        print("oracle", json.dumps({
            "family": family, "allclose_ratio": ratio,
            "max_diff": float(np.max(np.abs(F3.store.storage
                                            - F1.store.storage))),
            "scan_peak": float(eng.scan_peak),
            "device_calls": eng.stats["device_calls"],
            "batches": F3.stats["schedule"]["batches"]}), flush=True)


if __name__ == "__main__":
    main()

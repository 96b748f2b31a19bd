#!/usr/bin/env python3
"""What the port's spans (``repro_torch.core.spans.span``) cost, and how many
a served request opens:

    python3 scripts/span_cost.py [--device cpu] [--loops N] [--nx P E]

Prints one JSON line: the host µs of one empty ``with span(...)`` with no
profiler running (the benchmark's untimed state), of one bare
``record_function`` range with none running, and of one span under a
``torch.profiler`` of CPU and CUDA activities, each the mean over
``--loops`` ranges after a warm-up; then, for a 3-D Laplacian on ``P``³
(``guard="off"``) and a 3-D elasticity operator on ``E``³ (``guard=
"raise"``), the spans by name that one warm factor request and one solve
request of a ``CholeskyServer`` open (defaults 48 and 32, the benchmark's
sizes; each pays the plan build once).  The last line gives the card's name
and power limit.  Needs a CUDA card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.spans import span  # noqa: E402
from repro_torch.launch.serve import CholeskyServer  # noqa: E402
from repro_torch.sparse import elasticity_3d, laplacian_3d  # noqa: E402


def per_range_us(make, loops: int) -> float:
    for _ in range(1000):
        with make("x"):
            pass
    t0 = time.perf_counter()
    for _ in range(loops):
        with make("x"):
            pass
    return (time.perf_counter() - t0) / loops * 1e6


def spans_of(run, acts) -> dict:
    """Spans by name that ``run()`` opens under a profiler."""
    with profile(activities=acts) as prof:
        run()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            ev = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return dict(Counter(e["name"] for e in ev if e.get("ph") == "X"
                        and e.get("cat") == "user_annotation"))


def requests(A, guard: str, device: str, acts) -> dict:
    srv = CholeskyServer(device=device, guard=guard)
    srv.release(srv.handle("factor", A)["result"])  # the plan build
    h = {}

    def factor():
        h["f"] = srv.handle("factor", A)["result"]

    out = {"n": int(A.shape[0]), "guard": guard,
           "factor": spans_of(factor, acts)}
    b = np.ones(A.shape[0])
    srv.handle("solve", h["f"], b)  # solve.prepare, once per factor
    out["solve"] = spans_of(lambda: srv.handle("solve", h["f"], b), acts)
    for k in ("factor", "solve"):
        out[f"{k}_spans"] = sum(out[k].values())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--loops", type=int, default=200_000)
    ap.add_argument("--nx", type=int, nargs=2, default=(48, 32))
    args = ap.parse_args()
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("span_cost: needs a CUDA card (or --device cpu)",
              file=sys.stderr)
        return 2
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    rec = {"device": torch.cuda.get_device_name(0) if cuda else "cpu",
           "torch": torch.__version__,
           "span_off_us": per_range_us(span, args.loops),
           "record_function_off_us": per_range_us(record_function,
                                                  args.loops)}
    with profile(activities=acts):
        rec["span_on_us"] = per_range_us(span, args.loops // 10)
    P, E = args.nx
    rec["poisson"] = requests(laplacian_3d(P), "off", args.device, acts)
    rec["elasticity"] = requests(elasticity_3d(E), "raise", args.device, acts)
    print(json.dumps(rec), flush=True)
    if cuda:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True).stdout,
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The readings that the check's limits are set from, at a cell's own size:

    python3 cholbench/calibrate.py --cells A,B --seeds 12 --control-seeds 3 \
        [--seconds 6] [--first-seed N]

In one process a configuration's server is set up once (its plan is built
by the first seed and hit by the rest), then for each seed the cell's
traffic runs a short window of ``--seconds`` and its check reads the
port's answers: the lower readings.  For ``--control-seeds`` of those
seeds the control then answers in the port's place (``control`` of the
cell's loop: the float32 reference, one precision below the
configuration's float64): the upper readings.  One JSON line per reading
on standard output.  Needs a CUDA card, as ``run.py`` does.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, server, seeds, seconds: float, control_seeds: int,
             control_dtype) -> list:
    """One record per seed: the port's check readings, and for the first
    ``control_seeds`` seeds the control's."""
    cfg, tr = cell.cfg, cell.traffic
    A = cell.generator.make(**cfg["params"])
    out = []
    for k, seed in enumerate(seeds):
        st = cell.loop.prepare(A, cfg, tr, seed)
        cell.loop.warm(server, st)
        win = cell.loop.window(server, st, seconds, None)
        cell.loop.close(server, st)
        rec = {"cell": cell.workload["name"], "seed": seed,
               "requests": len(win.reqs), "failed": win.failed(),
               "port": {k_: c["value"] for k_, c in
                        cell.loop.check(st, win, cfg).items()}}
        if k < control_seeds:
            t0 = time.perf_counter()
            rec["control"] = {k_: c["value"] for k_, c in
                              cell.loop.control(st, cfg,
                                                control_dtype).items()}
            rec["control_s"] = time.perf_counter() - t0
        out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--first-seed", type=int, default=4_000_000_000)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch

    from cholbench import bench
    from repro_torch.launch.serve import CholeskyServer

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    spec = bench.load_spec(ROOT)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    servers = {}
    for name in args.cells.split(","):
        cell = bench.Cell(spec, name, root=ROOT)
        key = (cell.workload["config"], cell.cfg["guard"])
        if key not in servers:
            servers[key] = CholeskyServer(device="cuda",
                                          guard=cell.cfg["guard"])
        for rec in readings(cell, servers[key], seeds, args.seconds,
                            args.control_seeds, np.float32):
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

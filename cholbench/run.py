#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on one NVIDIA card:

    python3 cholbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration and a traffic mix; the run builds the
configuration's matrix, makes every value set and right-hand side from
``--seed``, sets up ``repro_torch.launch.serve.CholeskyServer`` on the card
and warms it, then drives it in a closed loop for ``--seconds``, timing
each request on the client's side.  Afterwards it checks a seeded sample
of the answers against the plain reference (``reference.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones, read from a ``torch.profiler``
trace of requests sent after the window), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its
limit; the last lines of standard error repeat the checks.

Without a card, with fewer cards than the cell asks for, without the port
beside it, or if the run loaded JAX or the JAX reference package, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The process's start on ``time.perf_counter``'s scale, from its
    start time in /proc (the first statement of this file where that is
    not readable)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - ticks / os.sysconf("SC_CLK_TCK"))
        return now - max(age, 0.0)
    except (OSError, ValueError, IndexError, AttributeError):
        return now


T_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from cholbench import bench

    cell = bench.Cell(bench.load_spec(ROOT), args.workload, root=ROOT)
    import torch

    chips = int(cell.workload["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"cholbench: needs {chips} CUDA card(s), found {found}",
              file=sys.stderr)
        return 2
    line, checks = bench.run(cell, seed=args.seed, seconds=args.seconds,
                             trace=bool(args.trace), t_start=T_START,
                             clock=time.perf_counter)
    bad = bench.forbidden_modules()
    if bad:
        print(f"cholbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for c in checks:
        print(c, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

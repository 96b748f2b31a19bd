"""What the metric readers under ``metrics/`` share.

A reader is a file ``metrics/<metric name>.py`` with ``read(ctx)``, which
returns the metric's value or None when its run has nothing to read.
``ctx`` is a ``Context``: the window as the client saw it, the trace of
the requests that follow it (traced runs only), the work's shapes and the peaks.
"""
from __future__ import annotations

import json
from pathlib import Path

from cholbench import work as work_count
from cholbench.trace import union_length

FACTOR_RANGES = ("factor.fill", "factor.stage", "factor.levels",
                 "factor.read_back")
SOLVE_RANGES = ("solve.prepare", "solve.levels")
PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())


class Context:
    def __init__(self, win, trace, work: dict, setup_s: float):
        self.win = win            # client.Window
        self.trace = trace        # trace.Trace, or None in untraced runs
        self.work = work          # {"sym", "n", "nrhs"}
        self.setup_s = setup_s
        self.peaks = PEAKS

    def shapes(self):
        return work_count.shapes(self.work["sym"])


def traced_requests(ctx, label: str) -> list:
    """The traced requests' harness ranges (``cholbench.<label>``)."""
    if ctx.trace is None or ctx.win.kind != label:
        return []
    return ctx.trace.named(f"cholbench.{label}")


def traced_count(ctx) -> int:
    """Factorizations or solves the traced requests asked for."""
    return sum(c for _, _, c, _ in ctx.win.traced_reqs())


def range_ms(ctx, label: str, name: str):
    """Host ms of the program's range ``name`` per traced factorization
    or solve."""
    reqs = traced_requests(ctx, label)
    n = traced_count(ctx)
    spans = [r for q in reqs for r in ctx.trace.named(name, q.t0, q.t1)]
    if not spans or not n:
        return None
    return sum(r.dur for r in spans) / n / 1e3


def server_ms(ctx, label: str, ranges) -> float | None:
    """Mean over traced requests of the request's time less the program's
    ``ranges`` inside it, ms.  The profiler's own cost on the host side of
    the request outside those ranges is in it."""
    reqs = traced_requests(ctx, label)
    if not reqs:
        return None
    own = [q.dur - sum(r.dur for name in ranges
                       for r in ctx.trace.named(name, q.t0, q.t1))
           for q in reqs]
    return sum(own) / len(own) / 1e3


def device_ms_in(ctx, label: str, name: str):
    """Device ms (the union of their intervals) of the kernels and copies
    issued inside the program's range ``name``, per traced factorization
    or solve."""
    reqs = traced_requests(ctx, label)
    n = traced_count(ctx)
    spans = [r for q in reqs for r in ctx.trace.named(name, q.t0, q.t1)]
    ops = ctx.trace.issued_in(spans) if spans else []
    if not ops or not n:
        return None
    return union_length(ops, float("-inf"), float("inf")) / n / 1e3


def traced_span(ctx, label: str):
    """(start, end) of the traced requests, on the trace's clock."""
    reqs = traced_requests(ctx, label)
    if not reqs:
        return None
    return reqs[0].t0, reqs[-1].t1


def busy_us(ctx, label: str):
    """(busy, window) microseconds: the union of device activity over the
    traced requests' span, and that span's length."""
    span = traced_span(ctx, label)
    if span is None:
        return None
    lo, hi = span
    return union_length(ctx.trace.device, lo, hi), hi - lo


def idle_pct(ctx, label: str):
    """One less the device's busy time per traced factorization or solve
    over the client's mean time of an untraced one, %.  The profiler
    stretches the traced requests' host side, not their device work, so
    the trace gives only the busy time."""
    bw = busy_us(ctx, label)
    n = traced_count(ctx)
    mean = mean_request_s(ctx, label)
    if bw is None or bw[0] <= 0 or not n or not mean:
        return None
    return 100.0 * (1.0 - bw[0] / 1e6 / n / mean)


def mean_request_s(ctx, label: str):
    """Seconds per factorization or solve, by the client's clock, over the
    requests that ran without the profiler."""
    if ctx.win.kind != label:
        return None
    reqs = [r for r in ctx.win.untraced() if r[3]]
    n = sum(c for _, _, c, _ in reqs)
    return sum(t1 - t0 for t0, t1, _, _ in reqs) / n if n else None

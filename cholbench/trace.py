"""Device trace of part of a window, read from ``torch.profiler``.

``Tracer`` wraps the profiler (CPU and CUDA activities) around the
requests that a traced run sends after its window.  ``Trace.load`` reads the profiler's Chrome
trace export and keeps four kinds of events on one clock (microseconds):

* host ranges: the ``record_function`` ranges of the port
  (``factor.fill`` ...) and of the harness (``cholbench.factor`` ...);
* launches: the CUDA runtime and driver calls, by correlation id;
* device ops: kernels, copies and memsets, with the correlation id of the
  call that issued them.

The readers under ``metrics/`` take their numbers from a ``Trace``.
"""
from __future__ import annotations

import json
import os
import tempfile
from bisect import bisect_right
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
RANGE_CAT = "user_annotation"


@dataclass
class Span:
    name: str
    t0: float
    t1: float
    corr: int = -1

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


def op_name(name: str) -> str:
    """A device op's name without its argument list and return type:
    ``void ns::(anonymous namespace)::panel_kernel<false>(double*, ...)``
    -> ``ns::(anonymous namespace)::panel_kernel<false>``."""
    s = name.strip()
    if s.endswith(")"):
        depth = 0
        for i in range(len(s) - 1, -1, -1):
            if s[i] == ")":
                depth += 1
            elif s[i] == "(":
                depth -= 1
                if depth == 0:
                    s = s[:i]
                    break
    depth, cut = 0, 0
    for i, c in enumerate(s):
        if c in "<(":
            depth += 1
        elif c in ">)":
            depth -= 1
        elif c == " " and depth == 0:
            cut = i + 1
    return s[cut:] or name


def function_name(name: str) -> str:
    """A kernel's bare function name: ``op_name`` without its namespaces
    and template arguments (``panel_kernel``)."""
    s, depth, out = op_name(name), 0, []
    for c in s:
        if c in "<(":
            depth += 1
        elif c in ">)":
            depth -= 1
        elif depth == 0:
            out.append(c)
    return "".join(out).rsplit("::", 1)[-1]


def union_length(spans, lo: float, hi: float) -> float:
    """Length of the union of ``spans`` clipped to [lo, hi]."""
    ivs = sorted((max(s.t0, lo), min(s.t1, hi)) for s in spans
                 if s.t1 > lo and s.t0 < hi)
    total, cur0, cur1 = 0.0, None, None
    for a, b in ivs:
        if cur1 is None or a > cur1:
            if cur1 is not None:
                total += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur1 is not None:
        total += cur1 - cur0
    return total


def gaps(spans, lo: float, hi: float) -> list:
    """The intervals of [lo, hi] that no span covers, as (t0, t1)."""
    out, t = [], lo
    for s in sorted(spans, key=lambda s: s.t0):
        if s.t1 <= t or s.t0 >= hi:
            continue
        if s.t0 > t:
            out.append((t, s.t0))
        t = max(t, s.t1)
    if t < hi:
        out.append((t, hi))
    return out


@dataclass
class Trace:
    ranges: list = field(default_factory=list)    # [Span] host ranges
    launches: dict = field(default_factory=dict)  # corr -> launch time
    device: list = field(default_factory=list)    # [Span] device ops

    @classmethod
    def from_events(cls, events: list) -> "Trace":
        """From the ``traceEvents`` of a Chrome trace."""
        tr = cls()
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            t0 = float(e.get("ts", 0.0))
            t1 = t0 + float(e.get("dur", 0.0))
            args = e.get("args") or {}
            corr = args.get("correlation", -1)
            if cat == RANGE_CAT:
                tr.ranges.append(Span(e.get("name", ""), t0, t1))
            elif cat in LAUNCH_CATS:
                tr.launches[corr] = t0
            elif cat in DEVICE_CATS:
                tr.device.append(Span(e.get("name", ""), t0, t1, corr))
        tr.ranges.sort(key=lambda s: s.t0)
        return tr

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls.from_events(json.load(f).get("traceEvents", []))

    # -- queries ----------------------------------------------------------
    def named(self, name: str, lo=None, hi=None) -> list:
        """Host ranges called ``name``, within [lo, hi] when given."""
        return [r for r in self.ranges if r.name == name
                and (lo is None or r.t0 >= lo) and (hi is None or r.t1 <= hi)]

    def issued_in(self, spans) -> list:
        """Device ops whose launch lies inside one of ``spans``."""
        ivs = sorted((s.t0, s.t1) for s in spans)
        starts = [a for a, _ in ivs]
        out = []
        for op in self.device:
            t = self.launches.get(op.corr)
            if t is None:
                continue
            i = bisect_right(starts, t) - 1
            if i >= 0 and ivs[i][0] <= t <= ivs[i][1]:
                out.append(op)
        return out

    def innermost(self, t: float) -> str | None:
        """Name of the innermost host range open at ``t``."""
        best = None
        for r in self.ranges:
            if r.t0 > t:
                break
            if r.t1 >= t:
                if best is None or r.t0 >= best.t0:
                    best = r
        return None if best is None else best.name

    def breakdown(self, lo: float, hi: float, top: int = 10) -> dict:
        """The device ops that took most time in [lo, hi], by name, and the
        longest idle gaps of the device there, each named by the innermost
        host range open at its middle ("client" when none is)."""
        by: dict = {}
        for op in self.device:
            if op.t1 > lo and op.t0 < hi:
                k = op_name(op.name)
                by[k] = by.get(k, 0.0) + (min(op.t1, hi) - max(op.t0, lo))
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(gaps(self.device, lo, hi), key=lambda g: g[0] - g[1])
        named = [[self.innermost((a + b) / 2) or "client", (b - a) / 1e6]
                 for a, b in idle[:top]]
        return {"device_ops": [[k, v / 1e6] for k, v in ops],
                "idle_gaps": named}


class Tracer:
    """The profiler over part of a window: ``start()`` before the first
    traced request, ``stop()`` after the last; ``trace()`` then reads it.
    The export goes to a temporary file under ``TMPDIR``, removed once
    read."""

    def __init__(self, cuda: bool = True):
        from torch.profiler import ProfilerActivity

        self.acts = [ProfilerActivity.CPU]
        if cuda:
            self.acts.append(ProfilerActivity.CUDA)
        self.prof = None

    def start(self) -> None:
        from torch.profiler import profile

        self.prof = profile(activities=self.acts)
        self.prof.__enter__()

    def stop(self) -> None:
        self.prof.__exit__(None, None, None)

    def trace(self) -> Trace:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            return Trace.load(path)
        finally:
            os.unlink(path)

"""What every traffic loop shares: the seed's random streams, the value sets
of a configuration, and the seeded sample of answers kept for the check.

Everything here runs off the clock (in set-up) or costs a few
microseconds a request (the sample's bookkeeping).
"""
from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp

# one independent random stream per use, so that changing how much one use
# draws never moves another's numbers
WINDOW_VALUES, WARM_VALUES, RHS, ORDER, SAMPLE, WARM_RHS, SHIFTS = range(1, 8)


def rng(seed: int, stream: int, *index: int) -> np.random.Generator:
    """The seed's stream ``stream`` (its ``index``-th substream, where
    given); any whole number is a seed."""
    return np.random.default_rng([int(seed) % 2 ** 64, stream,
                                  *map(int, index)])


class ValueSets:
    """Value sets of one sparsity pattern: ``D A D + s I`` with ``D``
    diagonal, log-uniform in ``scale_range``, and ``s`` uniform in
    ``shift_range``.  Every set keeps ``A``'s index arrays, so each
    matrix is canonical CSC with the pattern of ``A`` and exactly
    symmetric."""

    def __init__(self, A: sp.csc_matrix, values: dict):
        self.A = sp.csc_matrix(A)
        self.A.sort_indices()
        n = self.A.shape[0]
        self.col = np.repeat(np.arange(n), np.diff(self.A.indptr))
        self.row = self.A.indices
        self.diag = np.flatnonzero(self.row == self.col)
        if self.diag.shape[0] != n:
            raise ValueError("the pattern lacks part of its diagonal")
        self.scale = tuple(float(v) for v in values["scale_range"])
        self.shift = tuple(float(v) for v in values["shift_range"])

    def scaled(self, g: np.random.Generator) -> np.ndarray:
        """The values of ``D A D``, ``D`` drawn from ``g``."""
        n = self.A.shape[0]
        lo, hi = self.scale
        d = (np.exp(g.uniform(np.log(lo), np.log(hi), n)) if hi > lo
             else np.full(n, lo))
        return self.A.data * (d[self.row] * d[self.col])

    def draw_shift(self, g: np.random.Generator) -> float:
        return float(g.uniform(*self.shift))

    def draw(self, g: np.random.Generator) -> np.ndarray:
        data = self.scaled(g)
        data[self.diag] += self.draw_shift(g)
        return data

    def shifted(self, data: np.ndarray, diag: np.ndarray, s: float,
                out: np.ndarray | None = None) -> np.ndarray:
        """``data`` (the values of ``D A D``, whose diagonal is ``diag``)
        with ``s`` added to the diagonal, written into ``out`` (a copy of
        ``data`` by default); only ``out``'s diagonal is written."""
        if out is None:
            out = data.copy()
        out[self.diag] = diag + s
        return out

    def matrix(self, data: np.ndarray) -> sp.csc_matrix:
        M = sp.csc_matrix((data, self.A.indices, self.A.indptr),
                          shape=self.A.shape)
        M.has_sorted_indices = True
        M.has_canonical_format = True
        return M


class Reservoir:
    """A uniform sample of ``k`` of the answers offered, drawn from the
    seed's ``SAMPLE`` stream (reservoir sampling: the count need not be
    known ahead)."""

    def __init__(self, k: int, g: np.random.Generator):
        self.k, self.g = int(k), g
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.g.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


class Window:
    """What the client saw in a measured window: one ``(t0, t1, count,
    ok)`` per request on the host's clock (``count`` the factorizations or
    solves it asked for), the window's bounds, the engine's counters'
    growth over it, and how many of the last requests ran traced."""

    def __init__(self, kind: str):
        self.kind = kind
        self.reqs: list = []
        self.t_start = self.t_end = 0.0
        self.counters: dict = {}
        self.traced = 0

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start

    def completed(self) -> int:
        return sum(c for _, _, c, ok in self.reqs if ok)

    def failed(self) -> int:
        return sum(1 for *_, ok in self.reqs if not ok)

    def untraced(self) -> list:
        """The requests that ran without the profiler (all of them where
        every one was traced)."""
        return self.reqs[:len(self.reqs) - self.traced] or self.reqs

    def traced_reqs(self) -> list:
        return self.reqs[len(self.reqs) - self.traced:]


def run_window(srv, label: str, requests, seconds: float, tracer,
               traced: int, on_answer) -> Window:
    """The closed loop: one caller sends ``requests``'s next ``(kind,
    args, count)`` through ``srv.handle(kind, *args)`` and waits for the
    answer before the next, until ``seconds`` have passed; the window
    closes when the last request sent before then is answered.  Each
    request is a ``cholbench.<label>`` profiler range.  ``on_answer(i,
    result)`` sees each answer after its clock is read.  With a
    ``tracer``, ``traced`` more requests follow under the profiler: once it
    has run, the profiler leaves a cost on every launch, so it starts only
    after the last untraced request."""
    from torch.profiler import record_function

    win = Window(label)
    name = f"cholbench.{label}"
    before = dict(srv.engine.stats)
    nxt = iter(requests)
    i = first = 0
    tracing = False
    win.t_start = t1 = time.perf_counter()
    deadline = win.t_start + seconds
    while True:
        if i and t1 >= deadline and not tracing:
            if tracer is None:
                break
            tracer.start()
            tracing, first = True, i
        if tracing and i - first == traced:
            break
        kind, args, count = next(nxt)
        with record_function(name):
            t0 = time.perf_counter()
            res = srv.handle(kind, *args)
            t1 = time.perf_counter()
        win.reqs.append((t0, t1, count, bool(res["ok"])))
        on_answer(i, res)
        i += 1
    win.t_end = t1
    if tracing:
        tracer.stop()
        win.traced = traced
    win.counters = {k: srv.engine.stats[k] - before.get(k, 0)
                    for k in srv.engine.stats}
    return win


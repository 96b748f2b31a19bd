"""Refactor traffic: one pattern, a new value set every request.

Each request is ``handle("factor", A_i)``, then ``release`` of the
previous request's factor.  Request ``i`` takes the values ``D A D`` of
one of ``value_sets`` pooled scalings (made from the seed in set-up, in a
seeded order, cycling) and adds ``s_i I``, with ``s_i`` drawn from the
seed for that request alone, so that no two requests send the same
values however many the window holds.  Only the pooled set's diagonal is
rewritten, before the request is sent.  Set-up sends ``warm_requests``
more of their own first: the first one builds the pattern's plan.

The check: a seeded sample of ``check_sample`` factorizations of the
window, each held to ``reference.factor_berr`` on ``probes`` vectors
against the matrix that request sent, made again from the seed.
"""
from __future__ import annotations

from cholbench import client, reference


class State:
    def __init__(self, A, cfg: dict, tr: dict, seed: int):
        self.seed = seed
        self.vs = client.ValueSets(A, cfg["values"])
        g = client.rng(seed, client.WINDOW_VALUES)
        self.base = [self.vs.scaled(g) for _ in range(int(tr["value_sets"]))]
        if len(self.base) < 2:
            raise ValueError("value_sets: a set is rewritten while the "
                             "previous request's factor is held, so at "
                             "least 2")
        self.sets = [b.copy() for b in self.base]
        self.diags = [b[self.vs.diag] for b in self.base]
        g = client.rng(seed, client.WARM_VALUES)
        self.warm_sets = [self.vs.draw(g)
                          for _ in range(int(tr["warm_requests"]))]
        self.order = client.rng(seed, client.ORDER).permutation(len(self.sets))
        self.sample = client.Reservoir(int(tr["check_sample"]),
                                       client.rng(seed, client.SAMPLE))
        self.probes = int(tr["probes"])
        self.traced = int(tr["trace_requests"])
        self.sym = None
        self.last = None

    def shift(self, i: int) -> float:
        """Request ``i``'s diagonal shift."""
        return self.vs.draw_shift(client.rng(self.seed, client.SHIFTS, i))

    def set_of(self, i: int) -> int:
        return int(self.order[i % len(self.sets)])

    def values(self, i: int):
        """Request ``i``'s values, made anew from the seed: ``(set, s_i,
        data)``."""
        j, s = self.set_of(i), self.shift(i)
        return j, s, self.vs.shifted(self.base[j], self.diags[j], s)

    def requests(self):
        i = 0
        while True:
            j = self.set_of(i)
            self.vs.shifted(self.base[j], self.diags[j], self.shift(i),
                            out=self.sets[j])
            yield "factor", (self.vs.matrix(self.sets[j]),), 1
            i += 1


def prepare(A, cfg: dict, tr: dict, seed: int) -> State:
    return State(A, cfg, tr, seed)


def warm(srv, st: State) -> None:
    for data in st.warm_sets:
        res = srv.handle("factor", st.vs.matrix(data))
        if not res["ok"]:
            raise RuntimeError(f"warm-up request failed: {res['error']}")
        st.sym = srv.factors[res["result"]].sym
        srv.handle("release", res["result"])


def window(srv, st: State, seconds: float, tracer) -> client.Window:
    def on_answer(i, res):
        if res["ok"]:
            h = res["result"]
            f = srv.factors[h]
            # keep the answer's host panels and structure, not the factor
            # (whose device copy the release below must free)
            st.sample.offer((i, f.sym.perm, f.sym.super_ptr, f.sym.rows,
                             f.panels))
            if st.last is not None:
                srv.handle("release", st.last)
            st.last = h

    return client.run_window(srv, "factor", st.requests(), seconds, tracer,
                             st.traced, on_answer)


def close(srv, st: State) -> None:
    if st.last is not None:
        srv.handle("release", st.last)
        st.last = None


def check(st: State, win: client.Window, cfg: dict) -> dict:
    n = st.vs.A.shape[0]
    V = reference.probes(n, st.probes, st.seed)
    worst = 0.0 if st.sample.items else float("inf")
    for i, perm, super_ptr, rows, panels in st.sample.items:
        A = st.vs.matrix(st.values(i)[2])
        L = reference.PanelFactor(super_ptr, rows, panels, n)
        worst = max(worst, reference.factor_berr(A, perm, L, V))
    return {"factor_berr": {"value": worst,
                            "limit": cfg["limits"]["factor_berr"]}}


def work(st: State) -> dict:
    """What the metric readers need of the work: the supernode shapes."""
    return {"sym": st.sym, "n": st.vs.A.shape[0], "nrhs": 0}


def control(st: State, cfg: dict, dtype) -> dict:
    """The check with the reference in the port's place, factoring the
    window's first request's values in ``dtype``
    (``reference.banded_cholesky``)."""
    import numpy as np

    A = st.vs.matrix(st.values(0)[2])
    n = A.shape[0]
    F = reference.banded_cholesky(A, dtype)
    berr = reference.factor_berr(A, np.arange(n), F,
                                 reference.probes(n, st.probes, st.seed))
    return {"factor_berr": {"value": berr,
                            "limit": cfg["limits"]["factor_berr"]}}

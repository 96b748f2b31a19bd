"""Solve traffic: one resident factor, a new right-hand side every request.

Set-up factors one value set drawn from the seed and sends
``warm_requests`` solves (the first builds the solve's inverted diagonal
blocks).  Each request of the window is then ``handle("solve", h, b_i)``
with ``b_i`` of ``nrhs`` columns (a vector for one), taken in a seeded
order from ``rhs_pool`` right-hand sides made from the seed in set-up,
cycling if the window asks for more.

The check: a seeded sample of ``check_sample`` answers of the window,
each held to ``reference.solve_resid``.
"""
from __future__ import annotations

from cholbench import client, reference


class State:
    def __init__(self, A, cfg: dict, tr: dict, seed: int):
        self.seed = seed
        self.nrhs = int(tr["nrhs"])
        self.vs = client.ValueSets(A, cfg["values"])
        self.A = self.vs.matrix(self.vs.draw(client.rng(seed,
                                                        client.WARM_VALUES)))
        n = self.A.shape[0]
        shape = (int(tr["rhs_pool"]), n) + ((self.nrhs,) if self.nrhs > 1
                                             else ())
        self.pool = client.rng(seed, client.RHS).standard_normal(shape)
        self.order = client.rng(seed, client.ORDER).permutation(shape[0])
        self.warm_requests = int(tr["warm_requests"])
        self.sample = client.Reservoir(int(tr["check_sample"]),
                                       client.rng(seed, client.SAMPLE))
        self.traced = int(tr["trace_requests"])
        self.sym = None
        self.h = None

    def requests(self):
        P = self.pool.shape[0]
        i = 0
        while True:
            yield "solve", (self.h, self.pool[self.order[i % P]]), 1
            i += 1


def prepare(A, cfg: dict, tr: dict, seed: int) -> State:
    return State(A, cfg, tr, seed)


def warm(srv, st: State) -> None:
    res = srv.handle("factor", st.A)
    if not res["ok"]:
        raise RuntimeError(f"warm-up factor failed: {res['error']}")
    st.h = res["result"]
    st.sym = srv.factors[st.h].sym
    g = client.rng(st.seed, client.WARM_RHS)
    for _ in range(st.warm_requests):
        b = g.standard_normal(st.pool.shape[1:])
        res = srv.handle("solve", st.h, b)
        if not res["ok"]:
            raise RuntimeError(f"warm-up solve failed: {res['error']}")


def window(srv, st: State, seconds: float, tracer) -> client.Window:
    P = st.pool.shape[0]

    def on_answer(i, res):
        if res["ok"]:
            st.sample.offer((int(st.order[i % P]), res["result"]))

    return client.run_window(srv, "solve", st.requests(), seconds, tracer,
                             st.traced, on_answer)


def close(srv, st: State) -> None:
    if st.h is not None:
        srv.handle("release", st.h)
        st.h = None


def check(st: State, win: client.Window, cfg: dict) -> dict:
    worst = 0.0 if st.sample.items else float("inf")
    for j, x in st.sample.items:
        worst = max(worst, reference.solve_resid(st.A, x, st.pool[j]))
    return {"solve_resid": {"value": worst,
                            "limit": cfg["limits"]["solve_resid"]}}


def work(st: State) -> dict:
    """What the metric readers need of the work: the supernode shapes."""
    return {"sym": st.sym, "n": st.A.shape[0], "nrhs": st.nrhs}


def control(st: State, cfg: dict, dtype, count: int = 8) -> dict:
    """The check with the reference in the port's place: the factored
    matrix factored in ``dtype`` (``reference.banded_cholesky``), then the
    window's first ``count`` right-hand sides solved with it."""
    F = reference.banded_cholesky(st.A, dtype)
    P = st.pool.shape[0]
    worst = 0.0
    for i in range(count):
        b = st.pool[st.order[i % P]]
        worst = max(worst, reference.solve_resid(
            st.A, reference.banded_solve(F, b), b))
    return {"solve_resid": {"value": worst,
                            "limit": cfg["limits"]["solve_resid"]}}

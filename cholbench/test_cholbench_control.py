"""The check separates: at a small size on the CPU the port passes it,
while the control (the reference in the port's place, in float32) and a
run whose served path is broken underneath both fail it.

The control was also read at each cell's own size on the card
(``calibrate.py``); PERF.md gives those readings beside the limits."""
import time

import numpy as np
import pytest

from cholbench import bench
from cholbench.testing import small_cell
from repro_torch.launch.serve import CholeskyServer

SPEC = bench.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_where_the_port_passes(name):
    cell = small_cell(SPEC, name)
    A = cell.generator.make(**cell.cfg["params"])
    st = cell.loop.prepare(A, cell.cfg, cell.traffic, 2 ** 31 + 5)
    srv = CholeskyServer(device="cpu", guard=cell.cfg["guard"])
    cell.loop.warm(srv, st)
    win = cell.loop.window(srv, st, 0.2, None)
    cell.loop.close(srv, st)
    for c in cell.loop.check(st, win, cell.cfg).values():
        assert c["value"] <= c["limit"]
    for c in cell.loop.control(st, cell.cfg, np.float32).values():
        assert c["value"] > 3 * c["limit"]
    # the same reference in float64 passes: the precision is what fails
    for c in cell.loop.control(st, cell.cfg, np.float64).values():
        assert c["value"] <= c["limit"]


# ---------------------------------------------------------------------------
# faults planted in the served path
# ---------------------------------------------------------------------------
def _stale(monkeypatch):
    """Every request answers with the first answer the server gave."""
    first = {}
    factor, solve = CholeskyServer.factor, CholeskyServer.solve

    def stale_factor(self, A):
        h = factor(self, A)
        self.factors[h] = first.setdefault("F", self.factors[h])
        return h

    def stale_solve(self, h, b):
        return first.setdefault("x", solve(self, h, b))

    monkeypatch.setattr(CholeskyServer, "factor", stale_factor)
    monkeypatch.setattr(CholeskyServer, "solve", stale_solve)


def _half(monkeypatch):
    """Half of the batch left out: half of a factor's supernodes, half of
    a solve's right-hand sides."""
    factor, solve = CholeskyServer.factor, CholeskyServer.solve

    def half_factor(self, A):
        h = factor(self, A)
        for P in self.factors[h].panels[::2]:
            P[...] = 0.0
        return h

    def half_solve(self, h, b):
        x = solve(self, h, b)
        x[..., : max(1, x.shape[-1] // 2)] = 0.0
        return x

    monkeypatch.setattr(CholeskyServer, "factor", half_factor)
    monkeypatch.setattr(CholeskyServer, "solve", half_solve)


def _altered(monkeypatch):
    """One number of each answer altered by one part in a million where it
    is produced: a factor's largest off-diagonal entry, a solution's
    largest entry."""
    factor, solve = CholeskyServer.factor, CholeskyServer.solve

    def altered_factor(self, A):
        h = factor(self, A)
        tails = [P[P.shape[1]:] for P in self.factors[h].panels]
        T = max(tails, key=lambda T: np.abs(T).max(initial=0.0))
        T.reshape(-1)[np.argmax(np.abs(T))] *= 1 + 1e-6
        return h

    def altered_solve(self, h, b):
        x = solve(self, h, b)
        x.reshape(-1)[np.argmax(np.abs(x))] *= 1 + 1e-6
        return x

    monkeypatch.setattr(CholeskyServer, "factor", altered_factor)
    monkeypatch.setattr(CholeskyServer, "solve", altered_solve)


def _faults(spec=SPEC, root=bench.ROOT):
    """Each fault a cell of ``spec`` can have (one right-hand side a
    request has no batch to halve)."""
    for w in spec["workloads"]:
        name = w["name"]
        nrhs = bench.Cell(spec, name, root=root).traffic.get("nrhs")
        for fault in (_stale, _half, _altered):
            if not (fault is _half and nrhs == 1):
                yield name, fault


@pytest.mark.parametrize("name,fault", list(_faults()))
def test_a_broken_served_path_reads_not_correct(name, fault, monkeypatch):
    cell = small_cell(SPEC, name)
    fault(monkeypatch)
    line, checks = bench.run(cell, seed=2 ** 31 + 17, seconds=0.3,
                             trace=False, t_start=time.perf_counter(),
                             clock=time.perf_counter, device="cpu")
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())

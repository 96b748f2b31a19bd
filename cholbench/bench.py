"""One run of one cell: set-up, the measured window, the check, the line.

Everything that belongs to one configuration, traffic mix or metric is
found by the name that ``BENCHMARK.json`` gives it:

    configs/<config>.json       the deployment: generator, sizes, values,
                                guard, the check's limits
                                (``small``: its sizes in the CPU tests)
    matrices/<generator>.py     ``make(**params)``: the matrix
    traffic/<traffic>.json      the mix's parameters, naming its loop
    loops/<loop>.py             ``prepare``, ``warm``, ``window``,
                                ``close``, ``check``, ``work``
    metrics/<metric>.py         ``read(ctx)``: one metric

so a later cell, configuration, mix or metric is new files and entries.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
from pathlib import Path

from cholbench import readers
from cholbench.trace import Tracer

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that no run may load (the JAX reference package
#: and JAX itself), compared whole: ``repro_torch`` is not ``repro``
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_file(path: Path):
    """Import the file at ``path`` as a module of its own (a metric's file
    name holds a dot, so it is no importable name)."""
    name = "cholbench._by_name." + path.stem.replace(".", "__")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(names=None) -> list:
    """The ``FORBIDDEN`` top-level names among the loaded modules (or
    among ``names``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


class Cell:
    """One workload of ``BENCHMARK.json`` with its files loaded.
    ``params`` overrides the configuration's sizes (the CPU tests run a
    cell at a small grid)."""

    def __init__(self, spec: dict, name: str, *, root: Path = ROOT,
                 params: dict | None = None):
        self.spec = spec
        found = [w for w in spec["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        entry = [c for c in spec["configs"]
                 if c["name"] == self.workload["config"]][0]
        self.cfg = json.loads((root / entry["file"]).read_text())
        if params:
            self.cfg["params"] = dict(self.cfg["params"], **params)
        here = root / "cholbench"
        traffic = here / "traffic" / f"{self.workload['traffic']}.json"
        self.traffic = json.loads(traffic.read_text())
        self.generator = load_file(
            here / "matrices" / f"{self.cfg['generator']}.py")
        self.loop = load_file(here / "loops" / f"{self.traffic['loop']}.py")
        self.metrics_dir = here / "metrics"

    def metrics(self, section: str) -> list:
        """The entries of ``end_to_end`` or ``per_layer`` that this cell
        reports: those that list it, and those that list no cells (a
        per-layer one then where the end-to-end metric it moves is
        reported)."""
        name = self.workload["name"]
        e2e = {m["name"] for m in self.metrics("end_to_end")} \
            if section == "per_layer" else set()
        out = []
        for m in self.spec[section]:
            if "workloads" in m:
                if name in m["workloads"]:
                    out.append(m)
            elif section == "end_to_end" or m["moves"] in e2e:
                out.append(m)
        return out


def run(cell: Cell, *, seed: int, seconds: float, trace: bool, t_start: float,
        clock, device: str = "cuda") -> tuple[dict, list]:
    """Set up, measure, check; returns the result's line and the lines
    that give each compared number beside its limit.  ``t_start`` is the
    process's start on ``clock``'s scale."""
    import torch

    from repro_torch.launch.serve import CholeskyServer

    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg = cell.cfg
    A = cell.generator.make(**cfg["params"])
    st = cell.loop.prepare(A, cfg, cell.traffic, seed)
    srv = CholeskyServer(device=device, guard=cfg["guard"])
    cell.loop.warm(srv, st)
    tracer = None
    if trace:
        tracer = Tracer(cuda=cuda)
    sync()
    setup_s = clock() - t_start
    win = cell.loop.window(srv, st, seconds, tracer)
    sync()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    cell.loop.close(srv, st)
    work = cell.loop.work(st)
    del srv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    traced = tracer.trace() if tracer is not None else None

    checks = cell.loop.check(st, win, cfg)
    checks["failed_requests"] = {"value": win.failed(), "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    ctx = readers.Context(win, traced, work, setup_s)
    metrics = {}
    for m in cell.metrics("per_layer" if trace else "end_to_end"):
        v = load_file(cell.metrics_dir / f"{m['name']}.py").read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": len(win.reqs),
            "failed": win.failed(), "metrics": metrics, "device": dev}
    if traced is not None:
        bw = readers.busy_us(ctx, win.kind)
        if bw is not None:
            dev["busy_s"], dev["window_s"] = bw[0] / 1e6, bw[1] / 1e6
            line["breakdown"] = traced.breakdown(
                *readers.traced_span(ctx, win.kind))
    line["checks"] = checks
    lines = [f"check {k} {c['value']!r} limit {c['limit']!r}"
             for k, c in checks.items()]
    return line, lines

"""What the harness's CPU tests share, found through the spec and the files
it names and never through a cell's name, so that a new configuration,
traffic mix, loop or metric needs no edit of a test:

    small_cell      a cell at its configuration's ``small`` sizes
    request_kind    the kind of request a cell's loop opens its window with
    spec_problems   the per-layer metrics listed for cells that give them
                    nothing to read
"""
from __future__ import annotations

from pathlib import Path

from cholbench import bench


def small_cell(spec: dict, name: str, root: Path = bench.ROOT) -> bench.Cell:
    """Workload ``name`` of ``spec`` with its configuration's ``params``
    overridden by the file's ``small`` (the sizes a CPU test runs at)."""
    cell = bench.Cell(spec, name, root=root)
    if not cell.cfg.get("small"):
        entry = next(c for c in spec["configs"]
                     if c["name"] == cell.workload["config"])
        raise KeyError(f"{entry['file']} has no \"small\" key: the sizes "
                       "its cells run at in the CPU tests")
    return bench.Cell(spec, name, root=root, params=cell.cfg["small"])


class _Refusing:
    """A server that refuses every request: enough for a loop to open its
    window."""

    class engine:
        stats: dict = {}

    def handle(self, kind, *args):
        return {"ok": False, "error": "refused"}


def request_kind(cell: bench.Cell) -> str:
    """The kind of request (``factor``, ``solve``) that ``cell``'s loop, as
    its traffic file names it, opens its window with: the label of its
    ``cholbench.<kind>`` ranges, which the readers of ``<metric>.<kind>``
    read."""
    A = cell.generator.make(**cell.cfg["params"])
    st = cell.loop.prepare(A, cell.cfg, cell.traffic, 1)
    return cell.loop.window(_Refusing(), st, 0.0, None).kind


def spec_problems(spec: dict, root: Path = bench.ROOT) -> list:
    """What is wrong with the cells that ``spec``'s per-layer metrics list:
    a ``<metric>.<kind>`` metric, for a kind some loop opens, may list only
    cells whose loop opens requests of that kind; ``guard_ms.factor`` lists
    exactly the cells that send factor requests under a guard."""
    cells = {w["name"]: small_cell(spec, w["name"], root)
             for w in spec["workloads"]}
    kinds = {name: request_kind(cell) for name, cell in cells.items()}
    out = []
    for m in spec["per_layer"]:
        kind = m["name"].rsplit(".", 1)[-1]
        if kind not in kinds.values():
            continue
        for w in m.get("workloads", []):
            if kinds.get(w) != kind:
                out.append(f"{m['name']} lists {w}, whose loop opens "
                           f"{kinds.get(w)} requests")
    guarded = [name for name, cell in cells.items()
               if kinds[name] == "factor" and cell.cfg["guard"] != "off"]
    listed = next(m for m in spec["per_layer"]
                  if m["name"] == "guard_ms.factor").get("workloads")
    if listed != guarded:
        out.append(f"guard_ms.factor lists {listed}, the guarded factor "
                   f"cells are {guarded}")
    return out

"""A configuration and a cell join the benchmark as new files and entries
alone: in a copy of the benchmark's tree, a copy of ``poisson3d_48``'s file
under a new name with a ``small`` of its own, a copy of the ``solve1``
traffic under a new name, and entries in ``BENCHMARK.json`` (its own, and
its name in the solve metrics' lists).  At the small size on the CPU the
cell builds, its inputs repeat for a seed, a run gives a whole, correct
line, and the fault list and the spec's checks take it."""
import copy
import json
import shutil

import numpy as np
import pytest

from cholbench import bench, testing
from cholbench.test_cholbench_control import _faults
from cholbench.test_cholbench_harness import _check_whole_line, _run
from cholbench.test_cholbench_inputs import _inputs

CONFIG, TRAFFIC = "poisson3d_48b", "solve1b"
CELL = f"{CONFIG}.{TRAFFIC}"


def _write(path, obj):
    path.write_text(json.dumps(obj, indent=2) + "\n")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The root of a copy of the benchmark with the new configuration and
    cell added, and its spec."""
    root = tmp_path_factory.mktemp("tree")
    here = root / "cholbench"
    shutil.copytree(bench.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = bench.load_spec()
    cfg = json.loads((here / "configs" / "poisson3d_48.json").read_text())
    _write(here / "configs" / f"{CONFIG}.json",
           dict(cfg, name=CONFIG, small={"nx": 5}))
    shutil.copy(here / "traffic" / "solve1.json",
                here / "traffic" / f"{TRAFFIC}.json")
    entry = next(c for c in spec["configs"] if c["name"] == "poisson3d_48")
    spec["configs"].append(dict(entry, name=CONFIG,
                                file=f"cholbench/configs/{CONFIG}.json"))
    spec["workloads"].append({"name": CELL, "config": CONFIG,
                              "traffic": TRAFFIC, "chips": 1,
                              "why": "a copy of poisson3d_48.solve1"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "poisson3d_48.solve1" in m.get("workloads", []):
            m["workloads"].append(CELL)
    _write(root / "BENCHMARK.json", spec)
    return bench.load_spec(root), root


def test_the_new_cell_builds_at_its_configurations_small_size(tree):
    spec, root = tree
    cell = testing.small_cell(spec, CELL, root)
    assert cell.cfg["params"] == {"nx": 5}
    assert cell.generator.make(**cell.cfg["params"]).shape == (125, 125)
    assert testing.request_kind(cell) == "solve"


def test_a_configuration_without_small_is_named(tree):
    spec, root = tree
    path = root / "cholbench" / "configs" / f"{CONFIG}.json"
    cfg = json.loads(path.read_text())
    try:
        _write(path, {k: v for k, v in cfg.items() if k != "small"})
        with pytest.raises(KeyError, match=f"{CONFIG}.json has no \"small\""):
            testing.small_cell(spec, CELL, root)
    finally:
        _write(path, cfg)


def test_the_new_cells_inputs_repeat_for_a_seed(tree):
    spec, root = tree
    big = 2 ** 31 + 4321
    a, b, c = (_inputs(CELL, s, spec, root) for s in (big, big, big + 1))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert any(not np.array_equal(x, y) for x, y in zip(a[3:], c[3:]))


@pytest.mark.parametrize("trace_on", [False, True])
def test_the_new_cell_gives_a_whole_correct_line(tree, trace_on):
    spec, root = tree
    _check_whole_line(*_run(CELL, trace_on, spec=spec, root=root), trace_on)


def test_the_fault_list_takes_the_new_cell(tree):
    spec, root = tree
    faults = [(n, f.__name__) for n, f in _faults(spec, root)]
    assert [f for n, f in faults if n == CELL] == ["_stale", "_altered"]
    assert faults[:len(faults) - 2] == [(n, f.__name__) for n, f in _faults()]


def test_the_spec_checks_take_the_new_cell_and_keep_their_teeth(tree):
    spec, root = tree
    assert testing.spec_problems(spec, root) == []
    spec = copy.deepcopy(spec)
    by_name = {m["name"]: m for m in spec["per_layer"]}
    # a solve metric listing a refactor cell, which opens factor requests
    by_name["permute_ms.solve"]["workloads"].append("poisson3d_48.refactor")
    assert testing.spec_problems(spec, root) == [
        "permute_ms.solve lists poisson3d_48.refactor, whose loop opens "
        "factor requests"]
    by_name["permute_ms.solve"]["workloads"].pop()
    # a guarded factor cell left out of guard_ms.factor
    by_name["guard_ms.factor"]["workloads"].clear()
    assert testing.spec_problems(spec, root) == [
        "guard_ms.factor lists [], the guarded factor cells are "
        "['elasticity3d_32.refactor']"]

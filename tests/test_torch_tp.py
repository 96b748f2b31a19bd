"""Tensor-parallel compute over the mesh's "model" axis, held to the
reference's per-device work.

The reference's smoke cells (``tests/test_dryrun_smoke.py``: the smoke
configs at reduced shapes) compiled on 8 forced host devices at meshes
(1, 4) and (2, 4), as ``reference_flops`` in ``test_torch_dryrun.py``
compiles them at (1, 1) (x64 off, XLA's backend optimization level 0; in
a process of its own, since ``XLA_FLAGS`` must be set before JAX starts),
against the port's dry run of the same cells over a fake group of 4 and
8: per device, the port's matrix-product flops are at most 1.10 x the
reference's HLO count and, times the devices, at least the cell's (1, 1)
count (no work dropped); both sides' counts are pinned.  Each model rank
does its share of the heads, mlp columns, experts, vocab rows and SSD
heads, so the port's per-device bytes at (1, 4) are at most half of its
(1, 1) bytes for llama's train cell and mamba2's decode cell (before
tensor-parallel compute: 0.90 and 0.86).
"""
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from test_torch_dryrun import OVERRIDES, PINNED, SMOKE_CELLS, SMOKE_SHAPES

ROOT = Path(__file__).resolve().parents[1]
MESHES = ((1, 4), (2, 4))
#: per-device flops of each smoke cell: the reference's HLO count and the
#: port's dry run, pinned (before tensor-parallel compute the port counted
#: its (1, 1) flops over the data ranks only: llama's train cell
#: 6,710,886,400 at (1, 4) and 3,355,443,200 at (2, 4), mamba2's decode
#: cell 4,526,080 and 2,263,040)
REFERENCE = {
    ((1, 4), "llama3.2-1b/train_4k"): 1_811_939_328,
    ((1, 4), "deepseek-v3-671b/train_4k"): 3_344_357_888,
    ((1, 4), "jamba-1.5-large-398b/prefill_32k"): 1_919_549_440,
    ((1, 4), "mamba2-1.3b/decode_32k"): 1_131_520,
    ((2, 4), "llama3.2-1b/train_4k"): 889_192_448,
    ((2, 4), "deepseek-v3-671b/train_4k"): 1_600_531_712,
    ((2, 4), "jamba-1.5-large-398b/prefill_32k"): 959_774_720,
    ((2, 4), "mamba2-1.3b/decode_32k"): 565_760,
}
PORT = {
    ((1, 4), "llama3.2-1b/train_4k"): 1_811_939_328,
    ((1, 4), "deepseek-v3-671b/train_4k"): 3_344_357_888,
    ((1, 4), "jamba-1.5-large-398b/prefill_32k"): 1_964_113_920,
    ((1, 4), "mamba2-1.3b/decode_32k"): 1_134_592,
    ((2, 4), "llama3.2-1b/train_4k"): 905_969_664,
    ((2, 4), "deepseek-v3-671b/train_4k"): 1_672_178_944,
    ((2, 4), "jamba-1.5-large-398b/prefill_32k"): 982_056_960,
    ((2, 4), "mamba2-1.3b/decode_32k"): 567_296,
}
FLOP_RATIO = 1.10
#: the cells whose per-device bytes at (1, 4) are held to (1, 1)'s
MEMORY_CELLS = ("llama3.2-1b/train_4k", "mamba2-1.3b/decode_32k")
MEMORY_RATIO = 0.5

_REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    import jax
    jax.config.update("jax_enable_x64", False)
    import repro.configs as rc
    import repro.configs.registry as rreg
    import repro.launch.steps as rsteps
    from repro.launch.mesh import axis_types_kw
    from repro.launch.roofline import roofline

    shapes = {k: rreg.ShapeSpec(k, *v)
              for k, v in json.loads(sys.argv[1]).items()}
    for m in (rreg, rc, rsteps):
        m.SHAPES = shapes
    cells, overrides = json.loads(sys.argv[2]), json.loads(sys.argv[3])
    out = []
    for shape in json.loads(sys.argv[4]):
        mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                             **axis_types_kw(2))
        for arch, kind in cells:
            key = f"{arch}/{kind}"
            cell = rsteps.build_cell(arch, kind, mesh, smoke=True,
                                     unroll=False,
                                     overrides=overrides.get(key))
            compiled = rsteps.lower_cell(cell, mesh).compile(
                compiler_options={"xla_backend_optimization_level": 0})
            rf = roofline(compiled, compiled.as_text(), shape[0] * shape[1],
                          cfg=cell.cfg, spec=shapes[kind], kind=cell.kind)
            out.append([shape, key, rf["flops_per_device"]])
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def records():
    """Both sides' per-device counts at ``MESHES``: the reference compiled
    in a child process while the port traces here (one intra-op thread),
    and the port's (1, 1) records of ``MEMORY_CELLS``."""
    pytest.importorskip("jax")
    import repro_torch.configs as pc
    import repro_torch.configs.registry as preg
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.roofline import roofline

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    child = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, json.dumps(SMOKE_SHAPES),
         json.dumps(SMOKE_CELLS), json.dumps(OVERRIDES),
         json.dumps(MESHES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    shapes = {k: preg.ShapeSpec(k, *v) for k, v in SMOKE_SHAPES.items()}
    port, threads = {}, torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            for m in (preg, pc, steps):
                mp.setattr(m, "SHAPES", shapes)
            for shape in ((1, 1),) + MESHES:
                n = math.prod(shape)
                dist.init_process_group("fake", store=FakeStore(), rank=0,
                                        world_size=n)
                try:
                    mesh = make_host_mesh(shape, device="cpu")
                    for arch, kind in SMOKE_CELLS:
                        key = f"{arch}/{kind}"
                        if shape == (1, 1) and key not in MEMORY_CELLS:
                            continue
                        cell = steps.build_cell(arch, kind, mesh, smoke=True,
                                                unroll=False,
                                                overrides=OVERRIDES.get(key))
                        port[shape, key] = roofline(
                            steps.lower_cell(cell, mesh), n, cfg=cell.cfg,
                            spec=shapes[kind], kind=cell.kind)
                finally:
                    steps.set_active_mesh(None)
                    steps.set_mesh_rules({})
                    dist.destroy_process_group()
        out, err = child.communicate(timeout=300)
    finally:
        torch.set_num_threads(threads)
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode == 0, err[-3000:]
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1]
    ref = {(tuple(s), key): f for s, key, f in json.loads(line[7:])}
    return {"reference": ref, "port": port}


@pytest.mark.parametrize("shape,cell", list(REFERENCE))
def test_per_device_flops_match_the_references_hlo_count(records, shape,
                                                         cell):
    ref = records["reference"][shape, cell]
    got = records["port"][shape, cell]["flops_per_device"]
    assert ref == REFERENCE[shape, cell] and got == PORT[shape, cell]
    assert got <= FLOP_RATIO * ref, (got, ref)
    assert got * math.prod(shape) >= PINNED[cell]  # no work dropped
    rf = records["port"][shape, cell]
    assert rf["collective_wire_bytes_per_device"] > 0
    assert rf["memory_analysis"]["fits_80g"]


@pytest.mark.parametrize("cell", MEMORY_CELLS)
def test_per_device_bytes_at_1x4_at_most_half_of_1x1(records, cell):
    mem = {s: records["port"][s, cell]["memory_analysis"][
        "total_nonaliased_bytes"] for s in ((1, 1), (1, 4))}
    assert mem[(1, 4)] <= MEMORY_RATIO * mem[(1, 1)], mem


def test_a_cache_whose_positions_do_not_divide_is_refused():
    """``decode_32k``'s rule splits a cache's positions over "model"; the
    model reads that split from the rules, so a cell whose cache length
    does not divide over the model ranks (the plan leaves it whole) is
    refused when it is built, not computed on wrongly."""
    import repro_torch.configs.registry as preg
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(steps.SHAPES, "decode_32k",
                       preg.ShapeSpec("decode_32k", 510, 8, "decode"))
            mesh = make_host_mesh((1, 4), device="cpu")
            with pytest.raises(ValueError, match="510 positions"):
                steps.build_cell("llama3.2-1b", "decode_32k", mesh,
                                 smoke=True)
    finally:
        steps.set_active_mesh(None)
        steps.set_mesh_rules({})
        dist.destroy_process_group()

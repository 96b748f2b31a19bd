"""The port's dry run against the reference's.

The reference's smoke cells (``tests/test_dryrun_smoke.py``: the smoke
configs at reduced shapes) traced at mesh (1, 1) count the matrix-product
flops the reference's HLO parser counts for the same cells, compiled here
at (1, 1), and the count pinned.  ``dryrun.run_cell`` runs one smoke cell end
to end over a fake group of 8 in a process of its own; ``--list`` gives
the reference's ok/SKIP column; importing the dry-run modules sets no
environment variable and makes no process group; the MoE's global path on
a batch split over 16 data ranks (a fake group of 256) dispatches the
whole batch at the reference's capacity by one reduce-scatter and one
all-gather of the capacity rows over the data ranks."""
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

ROOT = Path(__file__).resolve().parents[1]

#: the reference's smoke cells and their reduced shapes
#: (``tests/test_dryrun_smoke.py:31-46``): (seq, batch, kind)
SMOKE_SHAPES = {"train_4k": (256, 8, "train"),
                "prefill_32k": (512, 4, "prefill"),
                "decode_32k": (512, 8, "decode")}
SMOKE_CELLS = [("llama3.2-1b", "train_4k"), ("deepseek-v3-671b", "train_4k"),
               ("jamba-1.5-large-398b", "prefill_32k"),
               ("mamba2-1.3b", "decode_32k")]
#: the overrides both sides build each cell with: deepseek's is cut to its
#: first two layers (one dense, one MoE) and the MTP block, which the
#: reference compiles in a few seconds less than its three (there both
#: sides count 13,467,805,696)
OVERRIDES = {"deepseek-v3-671b/train_4k": {"n_layers": 2}}
#: the reference's HLO dot flops of each cell at (1, 1), remat recompute
#: included: ``reference_flops`` computes them live, and the port's count
#: is held to both.  jamba's prefill matches since the port keeps the
#: SSM's conv window from the one computation of its pre-conv projections
#: (it computed them again over every position, 1,056,964,608 flops more:
#: the reference's program does too, and XLA's CSE merges the two).
PINNED = {"llama3.2-1b/train_4k": 6_710_886_400,
          "deepseek-v3-671b/train_4k": 10_489_849_856,
          "jamba-1.5-large-398b/prefill_32k": 7_585_923_072,
          "mamba2-1.3b/decode_32k": 4_526_080}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, as the other port test files pin it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reduced(registry, modules):
    """The smoke shapes in ``registry``'s ShapeSpec, patched into each of
    ``modules`` (a ``pytest.MonkeyPatch`` context's ``setattr`` pairs)."""
    shapes = {k: registry.ShapeSpec(k, *v) for k, v in SMOKE_SHAPES.items()}
    return shapes, [(m, "SHAPES", shapes) for m in modules]


@pytest.fixture(scope="module")
def reference_flops():
    """The reference's flops per device of each smoke cell at (1, 1)."""
    jax = pytest.importorskip("jax")
    import repro.configs as rc
    import repro.configs.registry as rreg
    import repro.launch.steps as rsteps
    from repro.launch.mesh import axis_types_kw
    from repro.launch.roofline import roofline

    shapes, patches = _reduced(rreg, (rreg, rc, rsteps))
    out = {}
    # as the reference's dry run runs: without x64, which ``repro.core``
    # turns on at import (with it the same cells count fewer dot flops:
    # 3,758,096,384 for llama's)
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        with pytest.MonkeyPatch.context() as mp:
            for m, name, v in patches:
                mp.setattr(m, name, v)
            mesh = jax.make_mesh((1, 1), ("data", "model"),
                                 **axis_types_kw(2))
            for arch, shape in SMOKE_CELLS:
                key = f"{arch}/{shape}"
                cell = rsteps.build_cell(arch, shape, mesh, smoke=True,
                                         unroll=False,
                                         overrides=OVERRIDES.get(key))
                # LLVM's optimization level changes the machine code, not
                # the optimized HLO whose dots are counted: at 0 the
                # compiles take half the time
                compiled = rsteps.lower_cell(cell, mesh).compile(
                    compiler_options={"xla_backend_optimization_level": 0})
                rf = roofline(compiled, compiled.as_text(), 1, cfg=cell.cfg,
                              spec=shapes[shape], kind=cell.kind)
                out[key] = rf["flops_per_device"]
    finally:
        jax.config.update("jax_enable_x64", x64)
    return out


@pytest.fixture(scope="module")
def port_records():
    """The port's roofline of each smoke cell at (1, 1): traced over a
    fake group of one rank."""
    import repro_torch.configs as pc
    import repro_torch.configs.registry as preg
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.roofline import model_flops_for, roofline

    shapes, patches = _reduced(preg, (preg, pc, steps))
    out = {}
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            for m, name, v in patches:
                mp.setattr(m, name, v)
            mesh = make_host_mesh((1, 1), device="cpu")
            for arch, shape in SMOKE_CELLS:
                key = f"{arch}/{shape}"
                cell = steps.build_cell(arch, shape, mesh, smoke=True,
                                        unroll=False,
                                        overrides=OVERRIDES.get(key))
                trace = steps.lower_cell(cell, mesh)
                out[key] = roofline(
                    trace, 1, cfg=cell.cfg, spec=shapes[shape],
                    kind=cell.kind, model_flops=model_flops_for(
                        cell.cfg, shapes[shape], cell.kind))
    finally:
        steps.set_active_mesh(None)
        steps.set_mesh_rules({})
        dist.destroy_process_group()
    return out


@pytest.mark.parametrize("cell", list(PINNED))
def test_smoke_cell_flops_equal_the_references_hlo_count(
        cell, port_records, reference_flops):
    rf = port_records[cell]
    assert rf["flops_per_device"] == reference_flops[cell] == PINNED[cell]
    assert rf["collective_wire_bytes_per_device"] == 0  # one rank
    mem = rf["memory_analysis"]
    assert mem["fits_80g"] and mem["argument_bytes"] > 0
    assert mem["total_nonaliased_bytes"] == (
        mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
        - mem["alias_bytes"])
    if cell.endswith("train_4k"):  # the parameters are updated in place
        assert 0 < mem["alias_bytes"] < mem["argument_bytes"]


_RUN_CELL = textwrap.dedent("""
    import json, sys
    from pathlib import Path
    import torch
    torch.set_num_threads(1)
    import repro_torch.configs as pc
    import repro_torch.configs.registry as preg
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun, steps
    shapes = {k: preg.ShapeSpec(k, *v) for k, v in json.loads(sys.argv[2]).items()}
    for m in (preg, pc, steps, dryrun):
        m.SHAPES = shapes
    steps.get_config = get_smoke_config
    dryrun.MESHES["single"] = ((2, 4), ("data", "model"))
    dryrun.RESULTS = Path(sys.argv[1])
    recs = [dryrun.run_cell("llama3.2-1b", s, "single", force=True)
            for s in ("train_4k", "decode_32k")]
    print("RESULT " + json.dumps(recs))
""")


def test_run_cell_end_to_end_over_a_fake_group_of_8(tmp_path):
    """``run_cell`` on the smoke llama at (2, 4), in a process of its own:
    the reference's record keys (``fits_80g`` for ``fits_16g``), a bound,
    wire bytes over the mesh for the train cell, and the top collectives
    named by where in the port they come from."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _RUN_CELL, str(tmp_path),
         json.dumps(SMOKE_SHAPES)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    train, decode = json.loads(line[len("RESULT "):])
    for rec in (train, decode):
        assert rec["ok"], rec.get("traceback")
        assert {"arch", "shape", "mesh", "devices", "ok", "lower_s",
                "compile_s", "n_params", "n_active_params", "roofline",
                "wall_s"} <= set(rec)
        rf = rec["roofline"]
        assert rec["devices"] == 8 and rf["bound"] in (
            "compute", "memory", "collective")
        assert {"argument_bytes", "output_bytes", "temp_bytes",
                "alias_bytes", "total_nonaliased_bytes",
                "fits_80g"} == set(rf["memory_analysis"])
        assert rf["memory_analysis"]["fits_80g"]
        assert rf["flops_per_device"] > 0
    assert train["roofline"]["collective_wire_bytes_per_device"] > 0
    assert train["roofline"]["collective_counts"]["all-gather"] > 0
    assert (tmp_path / "llama3.2-1b__train_4k__single.json").exists()


_LIST = textwrap.dedent("""
    import os, sys
    before = dict(os.environ)
    import torch.distributed as dist
    import repro_torch.launch.dryrun, repro_torch.launch.perf
    import repro_torch.launch.roofline, repro_torch.launch.hlo_analysis
    import repro_torch.launch.steps
    assert dict(os.environ) == before, "an import set the environment"
    assert not dist.is_initialized(), "an import made a process group"
    sys.argv = ["dryrun", "--list"]
    repro_torch.launch.dryrun.main()
""")


def test_list_gives_the_references_column_and_imports_are_clean():
    """Importing the dry-run modules sets no environment variable and
    makes no process group; then ``dryrun --list`` prints the reference's
    ok/SKIP column."""
    from repro.configs import ARCHS, SHAPES, cell_supported

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _LIST], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = {tuple(ln.split()[:2]): ln.split()[2].rstrip(":")
           for ln in proc.stdout.splitlines() if ln.strip()}
    want = {(a, s): "ok" if cell_supported(a, s)[0] else "SKIP"
            for a in ARCHS for s in SHAPES}
    assert got == want


def test_global_moe_on_a_split_batch_gathers_the_whole_batch():
    """The deepseek smoke config's train step (its first two layers: one
    dense, one MoE; and the MTP block) on a (16, 16) mesh over a
    fake group of 256, 32 x 64 tokens: each of the 16 data ranks holds 2
    rows.  The MoE layer dispatches the whole batch at the reference's
    capacity, ceil(N k / E * capacity_factor) for N = 2,048 (its global
    path on the whole batch), without gathering the batch: each rank fills
    the dispatch buffer's slots of its own tokens, one reduce-scatter over
    the data ranks gives each its block of the capacity rows (the
    reference's ``exp_cap`` split), it runs the experts on them (4 experts
    do not divide over 16 model ranks, so each runs all 4, as the rules
    leave them whole), and one all-gather brings the outputs back."""
    import repro.models.common as rcommon
    from repro.configs import get_smoke_config as ref_smoke
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh

    cfg = ref_smoke("deepseek-v3-671b")
    n_tokens, d, E = 32 * 64, cfg.d_model, cfg.moe_experts
    cap = int(math.ceil(n_tokens * cfg.moe_top_k / cfg.moe_experts
                        * cfg.capacity_factor))
    block = -(-cap // 16)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(steps.SHAPES, "train_4k",
                       ShapeSpec("train_4k", 64, 32, "train"))
            mesh = make_host_mesh((16, 16), device="cpu")
            cell = steps.build_cell("deepseek-v3-671b", "train_4k", mesh,
                                    smoke=True, unroll=False,
                                    overrides={"n_layers": 2})
            trace = steps.lower_cell(cell, mesh)
            steps.set_active_mesh(None)
            steps.set_mesh_rules({})
    finally:
        dist.destroy_process_group()
        rcommon.set_mesh_rules({})
    n_moe = 2 - cfg.first_dense_layers
    assert not [r for r in trace.ops if r.coll == "all-gather"
                and r.outputs[0][0] == (n_tokens, d)]
    moe = [r for r in trace.ops if "models/moe.py" in r.where]
    buffers = {r.outputs[0][0] for r in moe if r.op == "aten.zeros.default"}
    assert (E * 16 * block + 1, d) in buffers
    # the exchange (capacity rows leading): this rank's block, summed over
    # the 16 data ranks, and the outputs of every block gathered back
    scatters = [r for r in trace.ops if r.coll == "reduce-scatter"
                and r.group == 16 and r.outputs[0][0] == (block, E, d)]
    gathers = [r for r in trace.ops if r.coll == "all-gather"
               and r.group == 16 and r.outputs[0][0] == (16 * block, E, d)]
    assert len(scatters) >= n_moe and len(gathers) >= n_moe
    assert any(r.op == "aten.bmm.default" and r.inputs[0][0] == (E, block, d)
               for r in moe)
    # the embedding looks up this data rank's 2 rows of its vocab rows
    assert any(r.op == "aten.index.Tensor" and r.outputs[0][0] == (2, 64, d)
               for r in trace.ops if "models/" in r.where)


def test_decode_cache_write_at_a_tensor_length_equals_an_int_one():
    """The decode cell passes its cache length as a 0-d tensor, which the
    cache write clamps and writes on the device (a fake trace cannot read
    it on the host): the step equals the one at the same int length, bit
    for bit, on both families' caches."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_cache, init_params

    for arch in ("llama3.2-1b", "deepseek-v3-671b"):
        cfg = get_smoke_config(arch)
        m = init_params(cfg, 0, device="cpu")
        tok = torch.randint(0, cfg.vocab, (2, 9),
                            generator=torch.Generator().manual_seed(0))
        _, caches = m.prefill(tok[:, :8], init_cache(cfg, 2, 12, device="cpu"))
        a, ca = m.decode_step(tok[:, 8:], caches, 8)
        b, cb = m.decode_step(tok[:, 8:], caches,
                              torch.tensor(8, dtype=torch.int32))
        assert torch.equal(a, b), arch
        for x, y in zip(ca, cb):
            for slot in x:
                for k in x[slot]:
                    assert torch.equal(x[slot][k], y[slot][k]), (arch, k)


def test_train_step_gradients_keep_their_parameters_placements():
    """The counterpart of the reference's gradient sharding constraint
    (``launch/steps.py:151-157``): after the train cell's step on a (2, 4)
    mesh (fake tensors, a fake group of 8), every gradient is a DTensor
    laid out as its parameter, and the optimizer's moments too."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(steps.SHAPES, "train_4k",
                       ShapeSpec("train_4k", 64, 8, "train"))
            mesh = make_host_mesh((2, 4), device="cpu")
            cell = steps.build_cell("llama3.2-1b", "train_4k", mesh,
                                    smoke=True)
            with FakeTensorMode():
                model, opt, batch = cell.make_args("cpu")
                cell.step(model, opt, batch)
            params = list(model.parameters())
            assert params and all(
                isinstance(p.grad, DTensor)
                and p.grad.placements == p.placements
                and all(m.placements == p.placements
                        for m in opt.moments(p).values())
                for p in params)
    finally:
        steps.set_active_mesh(None)
        steps.set_mesh_rules({})
        dist.destroy_process_group()

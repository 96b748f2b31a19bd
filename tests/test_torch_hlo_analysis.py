"""The port's cost analysis of a recorded step against the reference's HLO
cost parser (``tests/test_hlo_analysis.py``): the reference's hand-written
HLO program, written in torch and recorded on fake tensors over a fake
process group of 8 ranks, gives the reference test's flops, wire bytes and
collective counts; each collective kind the port records moves the wire
bytes the reference's ``_collective_wire_bytes`` gives its HLO line; the
recorder tells the groups that span nodes apart and follows a step's live
bytes."""
import contextlib
import warnings

import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.launch.hlo_analysis import _collective_wire_bytes as ref_wire
from repro_torch.launch.hlo_analysis import (
    TraceRecorder,
    _collective_wire_bytes,
    analyze_trace,
)
from repro_torch.launch.mesh import NET, make_host_mesh
from repro_torch.launch.roofline import memory_analysis


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, as the other port test files pin it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    """A (2, 4) mesh over a fake group of 8: ``"model"`` groups of 4,
    ``"data"`` groups of 2."""
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield make_host_mesh((2, 4), device="cpu")
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def recording():
    with FakeTensorMode():
        rec = TraceRecorder("cpu", 8)
        with rec, warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            yield rec


def test_loop_totals_match_the_reference_test(mesh):
    """The reference test's program: a 12-trip loop of an 8x16 . 16x16 dot
    and an all-reduce over groups of 4, then an 8x16 . 16x32 dot and an
    all-gather over groups of 2 (whose result is the gathered f32[8,32])."""
    with recording() as rec:
        x = torch.empty(8, 16)
        w = torch.empty(16, 16)
        w2 = torch.empty(16, 32)
        for _ in range(12):
            x = funcol.all_reduce(x @ w, "sum", mesh.get_group("model"))
        y = x @ w2
        # each rank keeps its half of the rows and gathers the whole
        z = funcol.all_gather_tensor(y[:4], 0, mesh.get_group("data"))
        assert tuple(z.shape) == (8, 32)
    c = analyze_trace(rec.trace, 8)
    assert c.flops == 12 * 4096 + 8192
    ar = 2 * 512 * (3 / 4) * 12
    ag = 1024 * 0.5
    assert abs(c.coll_wire_bytes - (ar + ag)) < 1e-6
    assert c.coll_counts["all-reduce"] == 12
    assert c.coll_counts["all-gather"] == 1
    top = c.top_collectives()
    assert top[0]["kind"] == "all-reduce" and top[0]["count"] == 12
    assert top[0]["shape"] == "f32[8,16]"


def test_batched_dot_flops(mesh):
    with recording() as rec:
        torch.empty(4, 8, 16) @ torch.empty(4, 16, 32)
    assert analyze_trace(rec.trace, 8).flops == 2 * 4 * 8 * 16 * 32


_HLO_KIND = {"all-reduce": "all-reduce", "all-gather": "all-gather",
             "reduce-scatter": "reduce-scatter", "all-to-all": "all-to-all",
             "all-reduce (c10d)": "all-reduce"}


def _collective(kind: str, x, group):
    if kind == "all-reduce":
        return funcol.all_reduce(x, "sum", group)
    if kind == "all-gather":
        return funcol.all_gather_tensor(x, 0, group)
    if kind == "reduce-scatter":
        return funcol.reduce_scatter_tensor(x, "sum", 0, group)
    if kind == "all-to-all":
        return funcol.all_to_all_single(x, None, None, group)
    dist.all_reduce(x, group=group)  # torch.distributed's in-place call
    return x


@pytest.mark.parametrize("axis,g", [("model", 4), ("data", 2)])
@pytest.mark.parametrize("kind", list(_HLO_KIND))
def test_each_kind_moves_the_references_wire_bytes(mesh, kind, axis, g):
    """One collective of each kind over a group of ``g``: the recorded
    kind, group size and result, and its wire bytes equal to the
    reference's on the HLO line of the same result and replica groups."""
    with recording() as rec:
        out = _collective(kind, torch.empty(8, 16), mesh.get_group(axis))
        shape = tuple(out.shape)
    colls = [r for r in rec.trace.ops if r.coll]
    assert len(colls) == 1
    r = colls[0]
    assert (r.coll, r.group) == (_HLO_KIND[kind], g)
    assert r.outputs == [(shape, "f32")]
    dims = ",".join(map(str, shape))
    line = (f"  %c = f32[{dims}]{{1,0}} {_HLO_KIND[kind]}(%x), channel_id=1, "
            f"replica_groups=[{8 // g},{g}]<=[8], to_apply=%add")
    want_kind, want = ref_wire(line, 8)
    assert want_kind == r.coll
    assert analyze_trace(rec.trace, 8).coll_wire_bytes == want
    assert _collective_wire_bytes(r.coll, r.coll_bytes, g) == want


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather", "reduce-scatter",
                                  "all-to-all", "collective-permute"])
def test_wire_rule_matches_the_reference_at_every_group_size(kind):
    for g in (1, 2, 4, 16, 256):
        line = (f"  %c = bf16[64,32]{{1,0}} {kind}(%x), channel_id=1, "
                f"replica_groups=[{512 // g},{g}]<=[512]")
        assert _collective_wire_bytes(kind, 64 * 32 * 2, g) == \
            ref_wire(line, 512)[1]


def test_recorder_follows_live_bytes(mesh):
    """Arguments held, a temporary made and freed, an in-place update, a
    new output: the peak and the reference's total agree."""
    with FakeTensorMode():
        a = torch.empty(1024)                  # 4096 bytes of argument
        rec = TraceRecorder("cpu", 8)
        rec.hold([a])
        with rec:
            t = torch.empty(2048)              # 8192 bytes, freed
            del t
            a.add_(1.0)                        # updated in place
            u = torch.empty(512)               # 2048 bytes of output
        m = rec.finish([u], updated=[a])
    assert m == {"argument": 4096, "output": 2048 + 4096, "alias": 4096,
                 "peak": 4096 + 8192}
    mem = memory_analysis(rec.trace)
    assert mem["temp_bytes"] == 8192 - 2048
    assert mem["total_nonaliased_bytes"] == 4096 + 8192
    assert mem["fits_80g"]


def test_groups_that_span_nodes_are_told_apart(mesh, monkeypatch):
    """With nodes of 4 GPUs in rank order, rank 0's ``"model"`` group of
    the (2, 4) mesh is ranks 0-3, one node, and its ``"data"`` group ranks
    0 and 4, two: the recorder says so, and only the second's wire bytes
    cross nodes."""
    monkeypatch.setitem(NET, "gpus_per_node", 4)
    with recording() as rec:
        x = torch.empty(8, 16)
        funcol.all_reduce(x, "sum", mesh.get_group("model"))
        funcol.all_reduce(x, "sum", mesh.get_group("data"))
    colls = [(r.group, r.nodes) for r in rec.trace.ops if r.coll]
    assert colls == [(4, 1), (2, 2)]
    c = analyze_trace(rec.trace, 8)
    assert c.coll_wire_bytes == 2 * 512 * 3 / 4 + 2 * 512 / 2
    assert c.coll_wire_bytes_internode == 2 * 512 / 2

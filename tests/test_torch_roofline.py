"""The port's roofline arithmetic and cell axis trees against the
reference's: ``analytic_hbm_bytes``, ``_cache_bytes`` and
``model_flops_for`` bit for bit for the ten archs x four shapes x three
kinds x n_devices in {1, 8, 256, 512}; ``SHAPE_RULES``, ``batch_axes``,
``cache_axes_tree`` and ``pick_optimizer``'s ``quantize_v`` equal; and
``roofline``'s record keys and terms those of the reference's, with
``fits_80g`` for ``fits_16g``; a collective whose group spans nodes priced
at the network's rate."""
import jax
import pytest
import torch

import repro.launch.roofline as rroof
import repro.launch.steps as rsteps
from repro.configs import ARCHS, SHAPES, get_config
from repro_torch import configs as pconfigs
from repro_torch.launch import roofline as proof
from repro_torch.launch import steps as psteps
from repro_torch.launch.hlo_analysis import OpRecord, Trace
from repro_torch.launch.mesh import HW, NET

KINDS = ("train", "prefill", "decode")
N_DEVICES = (1, 8, 256, 512)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, as the other port test files pin it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_model_equals_the_references(arch):
    cfg, pcfg = get_config(arch), pconfigs.get_config(arch)
    for shape, spec in SHAPES.items():
        pspec = pconfigs.SHAPES[shape]
        assert (spec.batch, spec.seq, spec.kind) == \
            (pspec.batch, pspec.seq, pspec.kind)
        assert proof._cache_bytes(pcfg, spec.batch, spec.seq) == \
            rroof._cache_bytes(cfg, spec.batch, spec.seq)
        for kind in KINDS:
            assert proof.model_flops_for(pcfg, pspec, kind) == \
                rroof.model_flops_for(cfg, spec, kind)
            for n in N_DEVICES:
                assert proof.analytic_hbm_bytes(pcfg, pspec, kind, n) == \
                    rroof.analytic_hbm_bytes(cfg, spec, kind, n), (kind, n)


def _axes(tree):
    """The reference's axes tree with each leaf a plain tuple."""
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_axes_and_optimizer_equal_the_references(arch):
    cfg, pcfg = get_config(arch), pconfigs.get_config(arch)
    assert psteps.SHAPE_RULES == rsteps.SHAPE_RULES
    for shape in SHAPES:
        assert psteps.batch_axes(pcfg, shape) == rsteps.batch_axes(cfg, shape)
    assert psteps.cache_axes_tree(pcfg) == _axes(rsteps.cache_axes_tree(cfg))
    assert psteps.pick_optimizer(pcfg, [torch.zeros(1)]).quantize_v == \
        rsteps.pick_optimizer(cfg).quantize_v
    assert psteps.pick_optimizer(pcfg, [torch.zeros(1)]).defaults["lr"] == \
        rsteps.pick_optimizer(cfg).lr


class _Compiled:
    """What the reference's ``roofline`` reads of a compiled cell."""

    class _Mem:
        argument_size_in_bytes = 4096
        output_size_in_bytes = 6144
        temp_size_in_bytes = 6144
        alias_size_in_bytes = 4096

    def cost_analysis(self):
        return {"flops": 1.0, "bytes accessed": 2.0}

    def memory_analysis(self):
        return self._Mem()


_HLO = """\
HloModule t

ENTRY %main (p0: f32[8,16], p1: f32[16,32]) -> f32[8,32] {
  %p0 = f32[8,16]{1,0} parameter(0)
  %p1 = f32[16,32]{1,0} parameter(1)
  %dot.9 = f32[8,32]{1,0} dot(%p0, %p1), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %ag = f32[8,32]{1,0} all-gather(%dot.9), channel_id=2, replica_groups={{0,1},{2,3}}, dimensions={1}
}
"""


def test_roofline_record_equals_the_references():
    """The same program (one 8x16 . 16x32 product, an all-gather of the
    f32[8,32] result over groups of 2) and memory (4096 bytes of argument
    updated in place, 2048 new, a peak of 12288) through both rooflines:
    the same keys (``fits_80g`` for ``fits_16g``) and, against the H100's
    constants, the same terms."""
    cfg, pcfg = get_config("llama3.2-1b"), pconfigs.get_config("llama3.2-1b")
    spec, pspec = SHAPES["train_4k"], pconfigs.SHAPES["train_4k"]
    kw = dict(kind="train", model_flops=1e15)
    ref = rroof.roofline(_Compiled(), _HLO, 8, cfg=cfg, spec=spec, **kw)
    trace = Trace(ops=[
        OpRecord("aten.mm.default", [((8, 16), "f32"), ((16, 32), "f32")],
                 [((8, 32), "f32")], flops=8192.0),
        OpRecord("_c10d_functional.all_gather_into_tensor.default",
                 [((4, 32), "f32")], [((8, 32), "f32")], coll="all-gather",
                 group=2, coll_bytes=1024)],
        device="cpu", n_devices=8,
        memory={"argument": 4096, "output": 6144, "alias": 4096,
                "peak": 12288})
    got = proof.roofline(trace, 8, cfg=pcfg, spec=pspec, **kw)
    assert set(got) == set(ref) | {"collective_wire_bytes_per_device_internode"}
    assert got["collective_wire_bytes_per_device_internode"] == 0
    mem_ref = dict(ref["memory_analysis"])
    mem_ref["fits_80g"] = mem_ref.pop("fits_16g")
    assert got["memory_analysis"] == {**mem_ref, "fits_80g": True}
    assert got["flops_per_device"] == ref["flops_per_device"] == 8192
    assert got["collective_wire_bytes_per_device"] == \
        ref["collective_wire_bytes_per_device"] == 512
    assert got["collective_counts"] == ref["collective_counts"]
    assert got["hbm_bytes_per_device_analytic"] == \
        ref["hbm_bytes_per_device_analytic"]
    # the terms against the H100's constants
    assert got["t_compute_s"] == 8192 / HW["peak_flops"]
    assert got["t_memory_s"] == \
        got["hbm_bytes_per_device_analytic"] / HW["hbm_bw"]
    assert got["t_collective_s"] == 512 / HW["ici_bw"]
    assert got["bound"] == "memory"
    assert got["mfu_at_roofline"] == \
        1e15 / (got["t_memory_s"] * 8 * HW["peak_flops"])


def test_collectives_across_nodes_are_priced_at_the_networks_rate():
    """An all-reduce within one node and one whose group spans two: the
    first at NVLink's rate, the second at one GPU's network rate; the
    wire bytes the reference's record names count both."""
    def all_reduce(nodes):
        return OpRecord("_c10d_functional.all_reduce.default",
                        [((256,), "f32")], [((256,), "f32")],
                        coll="all-reduce", group=16, nodes=nodes,
                        coll_bytes=1024)
    trace = Trace(ops=[all_reduce(1), all_reduce(2)], n_devices=16,
                  memory={"argument": 0, "output": 0, "alias": 0, "peak": 0})
    got = proof.roofline(trace, 16)
    wb = 2 * 1024 * 15 / 16
    assert got["collective_wire_bytes_per_device"] == 2 * wb
    assert got["collective_wire_bytes_per_device_internode"] == wb
    assert got["t_collective_s"] == wb / HW["ici_bw"] + wb / NET["net_bw"]
    assert got["bound"] == "collective"

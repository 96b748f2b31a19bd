"""The port's sharding rules, axis trees and meshes against the reference's,
in one process on the CPU.

``_resolve`` (rule lookup) and ``shardings_from_axes`` (its divisibility
drop) give the reference's specs for every leaf of ``param_axes()``,
``state_axes`` (plain and ``quantize_v``) and the stacked cache axes of all
ten archs at full width, over the meshes (2, 2), (2, 4), (16, 16) and
(2, 16, 16), and the port's placements are those specs'.  The reference's
``_resolve`` reads only the mesh's axis names, so it gets an
``AbstractMesh`` (with the ``devices`` shape ``shardings_from_axes``
reads); the port gets a ``DeviceMesh`` over a fake process group of the
mesh's size.  Shapes come from ``jax.eval_shape``: nothing is allocated.
The production meshes build over fake groups of 256 and 512 ranks, and the
reference's ``moe_forward`` with ``moe_impl="local"`` under an active
(1, 1) mesh agrees with the port's in a gloo group of one rank."""
import contextlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

jax = pytest.importorskip("jax")
jnp = jax.numpy

from jax.sharding import AbstractMesh  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402

import repro.models.common as rcommon  # noqa: E402
from repro.configs import ARCHS, get_config  # noqa: E402
from repro.launch.steps import SHAPE_RULES  # noqa: E402
from repro.launch.steps import shardings_from_axes as ref_shardings  # noqa: E402
from repro.models import LanguageModel as RefModel  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import model as rmodel  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.models import ssm as rssm  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    HW,
    make_host_mesh,
    make_production_mesh,
)
from repro_torch.launch.steps import _spec, shardings_from_axes  # noqa: E402
from repro_torch.models import common as pcommon  # noqa: E402
from repro_torch.models import moe as pmoe  # noqa: E402
from repro_torch.models import model as pmodel  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402

MESHES = {(2, 2): ("data", "model"), (2, 4): ("data", "model"),
          (16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}


class _RefMesh(AbstractMesh):
    """An abstract mesh with the ``devices`` shape the reference's
    ``shardings_from_axes`` reads."""

    @property
    def devices(self):
        return np.empty(self.axis_sizes, dtype=object)


@contextlib.contextmanager
def fake_group(world: int):
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture(autouse=True)
def clean_rules():
    yield
    rcommon.set_mesh_rules({})
    pcommon.set_mesh_rules({})
    rcommon.set_active_mesh(None)
    pcommon.set_active_mesh(None)


def _is_axes(x) -> bool:
    return isinstance(x, tuple)


def _stack(tree):
    return jax.tree.map(lambda a: (None,) + tuple(a), tree, is_leaf=_is_axes)


def _cache_axes(mod, cfg) -> list:
    return [{f"slot{s}": _stack(mod.cache_axes(cfg, spec))
             for s, spec in enumerate(pattern)}
            for pattern, _ in rmodel.build_segments(cfg)]


@pytest.fixture(scope="module")
def trees():
    """arch -> [(what, reference shapes, reference axes, port axes)] at
    full width: the parameters, the optimizer state plain and quantized,
    the decode caches of the registry's decode_32k cell."""
    out = {}
    for arch in ARCHS:
        cfg, pcfg = get_config(arch), pconfigs.get_config(arch)
        shapes = jax.eval_shape(RefModel(cfg).init, jax.random.PRNGKey(0))
        axes = RefModel(cfg).param_axes()
        paxes = pmodel.param_axes(pcfg)
        rows = [("params", shapes, axes, paxes)]
        for q in (False, True):
            ropt = RefAdamW(quantize_v=q)
            rows.append((f"state q={q}", jax.eval_shape(ropt.init, shapes),
                         ropt.state_axes(axes),
                         AdamW([torch.zeros(1)], quantize_v=q).state_axes(
                             paxes)))
        caches = jax.eval_shape(lambda: rmodel.init_cache(cfg, 128, 32768))
        rows.append(("cache", caches, _cache_axes(rmodel, cfg),
                     _cache_axes(pmodel, pcfg)))
        out[arch] = rows
    return out


def test_default_rules_equal_references():
    assert pcommon.DEFAULT_RULES == rcommon.DEFAULT_RULES
    assert pcommon.Mesh_Rules() == rcommon.Mesh_Rules()


def test_axis_trees_equal_references():
    assert pmodel.attn_mod.gqa_axes() == rattn.gqa_axes()
    assert pmodel.attn_mod.mla_axes() == rattn.mla_axes()
    assert pmodel.ssm_mod.ssm_axes() == rssm.ssm_axes()
    for arch in ARCHS:
        cfg, pcfg = get_config(arch), pconfigs.get_config(arch)
        assert pmodel.param_axes(pcfg) == RefModel(cfg).param_axes(), arch
        assert pmoe.moe_axes(pcfg) == rmoe.moe_axes(cfg), arch
        for spec in set(rmodel.layer_specs(cfg)):
            assert pmodel.layer_axes(pcfg, spec) == rmodel.layer_axes(
                cfg, spec)
            assert pmodel.cache_axes(pcfg, spec, seq_axis="seq") == \
                rmodel.cache_axes(cfg, spec, seq_axis="seq")
        for q in (False, True):
            axes = RefModel(cfg).param_axes()
            assert AdamW([torch.zeros(1)], quantize_v=q).state_axes(
                pmodel.param_axes(pcfg)) == RefAdamW(
                    quantize_v=q).state_axes(axes)


@pytest.mark.parametrize("shape", list(MESHES))
def test_specs_and_placements_equal_references(trees, shape):
    names = MESHES[shape]
    ref_mesh = _RefMesh(shape, names)
    n = int(np.prod(shape))
    dropped = 0
    with fake_group(n):
        mesh = make_host_mesh(shape, names, device="cpu")
        for arch, rows in trees.items():
            for what, shapes, axes, paxes in rows:
                ref_sh = jax.tree.leaves(ref_shardings(ref_mesh, shapes,
                                                       axes))
                got = jax.tree.leaves(shardings_from_axes(mesh, shapes,
                                                          paxes),
                                      is_leaf=_is_axes)
                leaves = jax.tree.leaves(shapes)
                ax = jax.tree.leaves(axes, is_leaf=_is_axes)
                pax = jax.tree.leaves(paxes, is_leaf=_is_axes)
                assert len(ref_sh) == len(got) == len(leaves) == len(pax)
                for s, a, pa, rs, pl in zip(leaves, ax, pax, ref_sh, got):
                    want = tuple(rcommon._resolve(a, ref_mesh))
                    assert pcommon._resolve(pa, mesh) == want, (arch, a)
                    spec = _spec(mesh, s.shape, pa)
                    assert spec == tuple(rs.spec) + (None,) * (
                        len(s.shape) - len(rs.spec)), (arch, what, a)
                    assert pl == pcommon.spec_placements(spec, mesh)
                    dropped += spec != want + (None,) * (len(spec)
                                                         - len(want))
    if 16 in shape:  # mamba2's vocab 50,280 does not divide over 16
        assert dropped > 0


@pytest.mark.parametrize("rules", list(SHAPE_RULES))
def test_shape_rules_resolve_as_references(trees, rules):
    """The reference's per-cell rule overrides (``long_500k`` puts a cache
    dim over all three axes of the multi-pod mesh)."""
    rcommon.set_mesh_rules(SHAPE_RULES[rules])
    pcommon.set_mesh_rules(SHAPE_RULES[rules])
    ref_mesh = _RefMesh((2, 16, 16), MESHES[(2, 16, 16)])
    with fake_group(512):
        mesh = make_production_mesh(multi_pod=True, device="cpu")
        for arch, rows in trees.items():
            _, _, axes, paxes = rows[-1]
            for a, pa in zip(jax.tree.leaves(axes, is_leaf=_is_axes),
                             jax.tree.leaves(paxes, is_leaf=_is_axes)):
                spec = pcommon._resolve(pa, mesh)
                assert spec == tuple(rcommon._resolve(a, ref_mesh))
                pcommon.spec_placements(spec, mesh)


def test_logical_sharding_places_tuple_specs_in_mesh_order():
    with fake_group(512):
        mesh = make_production_mesh(multi_pod=True, device="cpu")
        assert pcommon.logical_sharding(("batch", "seq", "act_embed"),
                                        mesh) == (Shard(0), Shard(0),
                                                  Replicate())
        assert pcommon.logical_sharding(("vocab", "embed"), mesh) == (
            Replicate(), Shard(1), Shard(0))
        with pytest.raises(ValueError, match="mesh order"):
            pcommon.spec_placements((("data", "pod"),), mesh)
    x = torch.ones(3)
    assert pcommon.shard(x, "batch") is x


@pytest.mark.parametrize("multi_pod,world,shape", [
    (False, 256, (16, 16)), (True, 512, (2, 16, 16))])
def test_production_mesh_over_a_fake_group(multi_pod, world, shape):
    with fake_group(world):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        assert tuple(mesh.shape) == shape
        assert mesh.mesh_dim_names == (("pod", "data", "model") if multi_pod
                                       else ("data", "model"))
        with pytest.raises(ValueError, match="needs"):
            make_host_mesh((2, 2), device="cpu")
    with pytest.raises(ValueError, match="needs 256 devices, have 1"):
        make_production_mesh(device="cpu")
    assert set(HW) == {"peak_flops", "hbm_bw", "ici_bw", "hbm_per_chip"}


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield make_host_mesh((1, 1), device="cpu")
    finally:
        dist.destroy_process_group()


def test_local_moe_at_one_rank_matches_reference(one_rank):
    from repro.launch.mesh import make_host_mesh as ref_host_mesh
    from torch.distributed.tensor import distribute_tensor

    cfg = rcommon.ModelConfig(d_model=32, moe_experts=8, moe_top_k=2,
                              moe_d_ff=16, moe_impl="local",
                              param_dtype=jnp.float32,
                              compute_dtype=jnp.float32)
    pcfg = pcommon.ModelConfig(d_model=32, moe_experts=8, moe_top_k=2,
                               moe_d_ff=16, moe_impl="local",
                               param_dtype=torch.float32,
                               compute_dtype=torch.float32)
    p = rmoe.moe_params(cfg, jax.random.PRNGKey(0))
    x = np.random.default_rng(0).standard_normal((4, 16, 32)).astype(
        np.float32)
    mesh = ref_host_mesh((1, 1))
    rcommon.set_active_mesh(mesh)

    def loss(p, x):
        out, aux = rmoe.moe_forward(cfg, p, x)
        return jnp.sum(out ** 2) + aux, (out, aux)

    with mesh:
        (_, (out, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))

    pcommon.set_active_mesh(one_rank)
    plan = shardings_from_axes(one_rank, p, pmoe.moe_axes(pcfg))
    pd = {k: distribute_tensor(torch.from_numpy(np.array(v)), one_rank,
                               plan[k], src_data_rank=None).requires_grad_()
          for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    call = {k: v if k in pmoe.EXPERT_WEIGHTS else pcommon.whole(v)
            for k, v in pd.items()}
    pout, paux = pmoe.moe_forward(pcfg, call, xt)
    ((pout ** 2).sum() + paux).backward()

    def rel(a, b):
        b = np.asarray(b)
        return float(np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b)))

    assert rel(pout.detach().numpy(), out) <= 1e-5
    assert abs(float(paux.detach()) - float(aux)) <= 1e-6
    assert rel(xt.grad.numpy(), gx) <= 1e-5
    for k in p:
        assert rel(pd[k].grad.to_local().numpy(), gp[k]) <= 1e-5, k


def test_train_rejects_a_batch_that_does_not_split_over_the_data_ranks():
    from repro_torch.launch.train import train

    with fake_group(4):
        with pytest.raises(ValueError, match="batch 6 does not divide over "
                                             "4 data ranks"):
            train(mesh_shape=(4, 1), batch=6, seq=16, steps=1, device="cpu")
    assert pcommon.active_mesh() is None

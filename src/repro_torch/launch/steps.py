"""Placements from logical axes (port of ``shardings_from_axes`` of
``src/repro/launch/steps.py``), and the model's parameters put on a mesh
with them.
"""
from __future__ import annotations

from torch import nn
from torch.distributed.tensor import Shard, distribute_tensor

from repro_torch.models.common import _resolve, spec_placements
from repro_torch.models.convert import _entries


def _spec(mesh, shape, axes) -> tuple:
    """The reference's spec for a leaf: each dim's resolved mesh axes,
    dropped to replicated where the dim does not divide over them."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    spec = list(_resolve(axes, mesh))
    spec += [None] * (len(shape) - len(spec))
    fixed = []
    for dim, sp in zip(shape, spec):
        if sp is None:
            fixed.append(None)
            continue
        total = 1
        for ax in (sp if isinstance(sp, tuple) else (sp,)):
            total *= sizes.get(ax, 1)
        fixed.append(sp if dim % total == 0 else None)
    return tuple(fixed)


def shardings_from_axes(mesh, shapes_tree, axes_tree):
    """Map a logical-axes tree (tuple leaves) onto DTensor placements, one
    tuple per leaf of ``shapes_tree`` (leaves need a ``shape``; dicts and
    lists as in the reference's trees).

    Placements must divide exactly, so any dim not divisible by its
    assigned mesh axes is dropped to replicated (e.g. mamba2's vocab 50280
    over 16)."""
    def build(shapes, axes):
        if isinstance(shapes, dict):
            return {k: build(shapes[k], axes[k]) for k in shapes}
        if isinstance(shapes, (list, tuple)):
            return type(shapes)(build(s, a) for s, a in zip(shapes, axes))
        return spec_placements(_spec(mesh, tuple(shapes.shape), tuple(axes)),
                               mesh)
    return build(shapes_tree, axes_tree)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def model_placements(model, mesh) -> list:
    """(parameter, placements) for each of ``model``'s tensors: its leaf of
    ``shardings_from_axes`` over the reference's stacked tree, less the
    stacked leaves' leading layer axis (never sharded)."""
    axes = model.param_axes()
    out = []
    for path, ps, stacked in _entries(model):
        shape = ((len(ps),) if stacked else ()) + tuple(ps[0].shape)
        pl = spec_placements(_spec(mesh, shape, _at(axes, path)), mesh)
        if stacked:
            pl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
                       for p in pl)
        out.extend((p, pl) for p in ps)
    return out


def place_model(model, mesh) -> None:
    """Put ``model``'s parameters on ``mesh`` as DTensors with the plan's
    placements, each rank keeping its shard of the tensor it holds (every
    rank built the same weights from the same seed).  Build an optimizer
    after this: its moments follow the parameters' layout."""
    placed = {id(p): pl for p, pl in model_placements(model, mesh)}
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        dt = distribute_tensor(p.detach(), mesh, placed[id(p)],
                               src_data_rank=None)
        mod.register_parameter(leaf, nn.Parameter(
            dt, requires_grad=p.requires_grad))

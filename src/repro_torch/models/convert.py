"""Carry weights, caches and optimizer state between the reference's trees
and the port, both ways.

The reference keeps its parameters as one tree (``LanguageModel(cfg).init``
of ``repro.models``): ``embed``, ``head``, ``final_norm``, ``mtp`` and, per
segment, per pattern slot, each leaf stacked along a leading layer axis.
The port holds one module per layer.  ``from_reference_params(cfg, tree)``
builds a port ``LanguageModel`` from such a tree of numpy arrays
(``jax.tree.map(np.asarray, params)``) and ``load_reference_params`` loads
one into an existing model, unstacking each segment leaf into the
segment's per-layer modules; ``to_reference_params(model)`` restacks them.
The reference's ``(in, out)`` weight layout is kept as it is (the port
computes ``x @ w``), so nothing is transposed.  ``from_reference_caches``
does the same for a cache tree (the reference's ``init_cache`` layout,
which the port keeps).

``to_reference_opt_state`` / ``from_reference_opt_state`` carry
``optim.AdamW``'s state as the reference's ``{"step", "mu"}`` tree (``mu``
shaped like the parameter tree, each leaf ``{"m", "v"}`` or
``{"m", "vq", "vs"}``), so a training checkpoint written by either package
resumes in the other.

A numpy array of ``bfloat16`` (``ml_dtypes``) is taken bit for bit; numpy
has none of its own, so a bfloat16 model is not exported.

On a mesh a DTensor is exported whole (a collective: every rank calls), and
a tree is loaded into DTensor parameters and moments shard by shard, from
whole arrays or from DTensors laid out as they are (``restore_checkpoint``
with ``shardings=``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.device import resolve_device
from repro_torch.models.common import ModelConfig
from repro_torch.models.model import LanguageModel


def _tensor(a, device) -> torch.Tensor:
    """A numpy array (bfloat16 included) or a tensor, on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    if isinstance(t, DTensor):
        t = t.full_tensor()
    if t.dtype == torch.bfloat16:
        raise TypeError("numpy has no bfloat16: cast the model to float32 "
                        "to export it")
    return t.detach().cpu().numpy()


def _entries(model: LanguageModel):
    """Each leaf of the reference's parameter tree: (its path, the port
    parameters it holds, whether they are layers stacked along its leading
    axis)."""
    for k in ("embed", "head", "final_norm"):
        yield (k,), [getattr(model, k)], False
    for si, (pattern, r) in enumerate(model.segments):
        for slot in range(len(pattern)):
            layers = model.layers[si][f"slot{slot}"]
            for sub, _ in layers[0].named_parameters():
                yield (("segments", si, f"slot{slot}") + tuple(sub.split(".")),
                       [layers[li].get_parameter(sub) for li in range(r)],
                       True)
    if model.cfg.mtp_depth:
        for sub, p in model.mtp.named_parameters():
            yield ("mtp",) + tuple(sub.split(".")), [p], False


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def reference_tree(model: LanguageModel, leaf) -> dict:
    """The reference's parameter tree with ``leaf(params, stacked)`` at each
    leaf (``params`` the port parameters that leaf holds)."""
    tree = {"segments": [{} for _ in model.segments]}
    for path, ps, stacked in _entries(model):
        node = tree
        for k in path[:-1]:
            node = node[k] if isinstance(k, int) else node.setdefault(k, {})
        node[path[-1]] = leaf(ps, stacked)
    return tree


def _load_entries(model: LanguageModel, tree: dict, depth: int = 0):
    """(port parameter, its reference leaf or the node ``depth`` levels
    above the leaves, layer index or None) for every parameter, after
    checking that ``tree`` has the model's leaves."""
    entries = list(_entries(model))
    want = {path for path, _, _ in entries}
    got = {p[:len(p) - depth] for p in _paths(tree)}
    if want != got:
        raise ValueError(f"parameter trees differ: "
                         f"{sorted(map(str, want ^ got))}")
    for path, ps, stacked in entries:
        a = _at(tree, path)
        for li, p in enumerate(ps):
            yield p, a, li if stacked else None


def _copy_into(dst: torch.Tensor, a, index, what) -> None:
    src = _tensor(a if index is None else a[index], dst.device)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: shape {tuple(src.shape)} against "
                         f"{tuple(dst.shape)}")
    if isinstance(dst, DTensor) and not isinstance(src, DTensor):
        src = distribute_tensor(src, dst.device_mesh, dst.placements,
                                src_data_rank=None)
    with torch.no_grad():
        dst.copy_(src)


def to_reference_params(model: LanguageModel) -> dict:
    """The model's parameters as the reference's tree of numpy arrays."""
    return reference_tree(model, lambda ps, stacked: (
        np.stack([_numpy(p) for p in ps]) if stacked else _numpy(ps[0])))


def load_reference_params(model: LanguageModel, tree: dict) -> None:
    """Copy the reference's parameter tree (numpy arrays or tensors) into
    ``model``'s parameters."""
    for p, a, li in _load_entries(model, tree):
        _copy_into(p, a, li, "parameter")


def from_reference_params(cfg: ModelConfig, tree: dict,
                          device=None) -> LanguageModel:
    """A port ``LanguageModel`` holding the reference's weights."""
    model = LanguageModel(cfg, device=resolve_device(device))
    load_reference_params(model, tree)
    return model


def to_reference_opt_state(model: LanguageModel, optimizer) -> dict:
    """``optimizer``'s state (an ``optim.AdamW`` over ``model``) as the
    reference's ``{"step", "mu"}`` tree of numpy arrays."""
    def leaf(ps, stacked):
        sts = [optimizer.moments(p) for p in ps]
        return {k: np.stack([_numpy(st[k]) for st in sts]) if stacked
                else _numpy(sts[0][k]) for k in sts[0]}

    return {"step": _numpy(optimizer.state["step"]).astype(np.int32),
            "mu": reference_tree(model, leaf)}


def from_reference_opt_state(model: LanguageModel, optimizer,
                             tree: dict) -> None:
    """Load the reference's ``{"step", "mu"}`` tree into ``optimizer`` (an
    ``optim.AdamW`` over ``model``)."""
    for p, mu, li in _load_entries(model, tree["mu"], depth=1):
        st = optimizer.moments(p)
        if set(mu) != set(st):
            raise ValueError(f"optimizer state {sorted(mu)} against "
                             f"{sorted(st)} (quantize_v differs)")
        for k in st:
            _copy_into(st[k], mu[k], li, f"optimizer state {k}")
    step = tree["step"]
    if isinstance(step, DTensor):
        step = step.full_tensor()
    optimizer.state["step"] = _tensor(step, "cpu").to(torch.int32)


def from_reference_caches(caches: list, device=None) -> list:
    """The reference's cache tree (numpy leaves) in the port's layout."""
    dev = resolve_device(device)
    return [{slot: {k: _tensor(a, dev) for k, a in c.items()}
             for slot, c in seg.items()} for seg in caches]

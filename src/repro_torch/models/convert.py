"""Carry the reference's weights and caches into the port.

``from_reference_params(cfg, tree)`` takes the reference's parameter tree
(``LanguageModel(cfg).init(key)`` of ``repro.models``) as numpy arrays —
``jax.tree.map(np.asarray, params)`` — and loads it into a port
``LanguageModel``: each segment's stacked leaves are unstacked along their
leading layer axis into the segment's per-layer modules.  The reference's
``(in, out)`` weight layout is kept as it is (the port computes ``x @ w``),
so nothing is transposed.  ``from_reference_caches`` does the same for a
cache tree (the reference's ``init_cache`` layout, which the port keeps),
so a decode step can start from the same cache on both sides.

A numpy array of ``bfloat16`` (``ml_dtypes``) is taken bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import ModelConfig
from repro_torch.models.model import LanguageModel


def _tensor(a, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``, bfloat16 included."""
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _load(module, tree: dict, index=None) -> None:
    """Copy ``tree``'s leaves (at ``index`` of their leading axis, if given)
    into the parameters of the ``Params`` tree ``module``."""
    names = set(module._parameters) | set(module._modules)
    if set(tree) != names:
        raise ValueError(f"parameter names differ: {sorted(tree)} against "
                         f"{sorted(names)}")
    for k, v in tree.items():
        if isinstance(v, dict):
            _load(module[k], v, index)
            continue
        a = np.asarray(v) if index is None else np.asarray(v)[index]
        dst = module[k]
        if tuple(a.shape) != tuple(dst.shape):
            raise ValueError(f"{k}: shape {a.shape} against {tuple(dst.shape)}")
        dst.data = _tensor(a, dst.device).to(dst.dtype)


def from_reference_params(cfg: ModelConfig, tree: dict,
                          device=None) -> LanguageModel:
    """A port ``LanguageModel`` holding the reference's weights."""
    model = LanguageModel(cfg, device=resolve_device(device))
    for k in ("embed", "head", "final_norm"):
        dst = getattr(model, k)
        dst.data = _tensor(tree[k], dst.device).to(dst.dtype)
    if len(tree["segments"]) != len(model.segments):
        raise ValueError("segment plans differ")
    for si, (pattern, r) in enumerate(model.segments):
        for slot in range(len(pattern)):
            name = f"slot{slot}"
            for li in range(r):
                _load(model.layers[si][name][li], tree["segments"][si][name],
                      li)
    if cfg.mtp_depth:
        _load(model.mtp, tree["mtp"])
    return model


def from_reference_caches(caches: list, device=None) -> list:
    """The reference's cache tree (numpy leaves) in the port's layout."""
    dev = resolve_device(device)
    return [{slot: {k: _tensor(a, dev) for k, a in c.items()}
             for slot, c in seg.items()} for seg in caches]

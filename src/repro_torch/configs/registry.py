"""Architecture / shape registry (port of ``src/repro/configs/registry.py``).

10 assigned architectures x 4 input-shape sets = 40 cells.  ``long_500k``
requires sub-quadratic attention over the cached context and is only run for
the SSM/hybrid architectures.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass

import torch

from repro_torch.models.common import ModelConfig

_MODULES = {
    "llava-next-34b": "llava_next_34b",
    "llama3.2-1b": "llama3_2_1b",
    "granite-20b": "granite_20b",
    "yi-9b": "yi_9b",
    "yi-6b": "yi_6b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "dbrx-132b": "dbrx_132b",
    "mamba2-1.3b": "mamba2_1_3b",
    "musicgen-large": "musicgen_large",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}

ARCHS = tuple(_MODULES)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq: int
    batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def cell_supported(arch: str, shape: str) -> tuple[bool, str]:
    cfg = get_config(arch)
    spec = SHAPES[shape]
    if spec.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, ("long_500k needs sub-quadratic context handling; "
                       f"{arch} is pure full-attention")
    return True, ""


def input_specs(cfg: ModelConfig, shape: str) -> dict:
    """``(shape, dtype)`` of every model input of this cell (PyTorch has no
    ``ShapeDtypeStruct``; nothing is allocated)."""
    spec = SHAPES[shape]
    B, S = spec.batch, spec.seq
    i32 = torch.int32
    out: dict = {}
    if spec.kind in ("train", "prefill"):
        out["tokens"] = ((B, S), i32)
        if spec.kind == "train":
            out["labels"] = ((B, S), i32)
        if cfg.frontend_tokens:
            out["frontend"] = ((B, cfg.frontend_tokens, cfg.d_model),
                               cfg.compute_dtype)
    else:  # decode
        out["tokens"] = ((B, 1), i32)
        out["cache_len"] = ((), i32)
    return out

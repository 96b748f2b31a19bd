"""The LM stack (port of ``src/repro/models``): decoder-only families (dense
GQA/MQA, MLA, MoE, SSM, hybrid) assembled from shared building blocks, with
logical-axis sharding on a ``torch.distributed`` device mesh: serving
(forward, prefill, decode) and training (the backward pass with remat,
``train_step_fn``), on one card or on a mesh."""
from repro_torch.models.common import (
    Mesh_Rules,
    ModelConfig,
    active_mesh,
    logical_sharding,
    set_active_mesh,
    set_mesh_rules,
)
from repro_torch.models.model import (
    LanguageModel,
    decode_step_fn,
    init_cache,
    init_params,
    prefill_step_fn,
    train_step_fn,
)

__all__ = [
    "ModelConfig", "Mesh_Rules", "logical_sharding", "set_mesh_rules",
    "set_active_mesh", "active_mesh",
    "LanguageModel", "init_params", "init_cache", "train_step_fn",
    "prefill_step_fn", "decode_step_fn",
]

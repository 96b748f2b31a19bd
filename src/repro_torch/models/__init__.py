"""The LM stack (port of ``src/repro/models``): decoder-only families (dense
GQA/MQA, MLA, MoE, SSM, hybrid) assembled from shared building blocks, on
one card: serving (forward, prefill, decode) and training (the backward
pass with remat, ``train_step_fn``).  The multi-device sharding rules come
with a later slice."""
from repro_torch.models.common import ModelConfig
from repro_torch.models.model import (
    LanguageModel,
    decode_step_fn,
    init_cache,
    init_params,
    prefill_step_fn,
    train_step_fn,
)

__all__ = [
    "ModelConfig", "LanguageModel", "init_params", "init_cache",
    "train_step_fn", "prefill_step_fn", "decode_step_fn",
]

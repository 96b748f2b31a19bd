"""The LM stack (port of ``src/repro/models``): decoder-only families (dense
GQA/MQA, MLA, MoE, SSM, hybrid) assembled from shared building blocks, on
one card.  Serving (forward, prefill, decode) is ported; training (the
backward pass, ``train_step_fn``) and the multi-device sharding rules come
with later slices."""
from repro_torch.models.common import ModelConfig
from repro_torch.models.model import (
    LanguageModel,
    decode_step_fn,
    init_cache,
    init_params,
    prefill_step_fn,
)

__all__ = [
    "ModelConfig", "LanguageModel", "init_params", "init_cache",
    "prefill_step_fn", "decode_step_fn",
]

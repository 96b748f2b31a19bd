"""llava-next-34b  [vlm]  60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

Backbone only: the vision tower is a STUB — input_specs() provides 576
precomputed patch embeddings that replace the first 576 token positions.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab=64000, act="swiglu",
    frontend_tokens=576,
)

SMOKE = ModelConfig(
    name="llava-next-34b-smoke", family="vlm",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=512, act="swiglu", frontend_tokens=8, q_chunk=64,
)

"""musicgen-large  [audio]  48L d_model=2048 32H (MHA kv=32) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens [arXiv:2306.05284; hf]

Backbone only: the EnCodec encoder / text conditioner is a STUB —
input_specs() provides 256 precomputed conditioning-frame embeddings."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=2048, act="gelu",
    frontend_tokens=256,
)

SMOKE = ModelConfig(
    name="musicgen-large-smoke", family="audio",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab=128, act="gelu", frontend_tokens=8, q_chunk=64,
)

"""yi-6b  [dense]  32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000
[arXiv:2403.04652; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab=64000, act="swiglu",
)

SMOKE = ModelConfig(
    name="yi-6b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=288, vocab=512, act="swiglu", q_chunk=64,
)

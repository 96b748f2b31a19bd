"""llama3.2-1b  [dense]  16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256
[hf:meta-llama/Llama-3.2-1B; unverified]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab=128256, act="swiglu", rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="llama3.2-1b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=512, act="swiglu", q_chunk=64,
)

"""dbrx-132b  [moe]  40L d_model=6144 48H (GQA kv=8) expert d_ff=10752
vocab=100352, MoE 16 experts top-4, fine-grained [hf:databricks/dbrx-base]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab=100352, act="swiglu",
    moe_experts=16, moe_top_k=4, moe_d_ff=10752,
)

SMOKE = ModelConfig(
    name="dbrx-132b-smoke", family="moe",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=128, vocab=512, act="swiglu",
    moe_experts=4, moe_top_k=2, moe_d_ff=128, q_chunk=64,
)

"""deepseek-v3-671b  [moe]  61L d_model=7168 128H (MLA) expert d_ff=2048
vocab=129280, MoE 1 shared + 256 routed top-8, MTP [arXiv:2412.19437; hf]

MLA dims per the paper: q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64,
v_head=128.  First 3 layers use a dense FFN (d_ff=18432)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=18432, vocab=129280, act="swiglu",
    moe_experts=256, moe_top_k=8, moe_d_ff=2048, moe_shared_experts=1,
    first_dense_layers=3,
    mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    mtp_depth=1,
)

SMOKE = ModelConfig(
    name="deepseek-v3-smoke", family="moe",
    n_layers=3, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab=512, act="swiglu",
    moe_experts=4, moe_top_k=2, moe_d_ff=64, moe_shared_experts=1,
    first_dense_layers=1,
    mla=True, q_lora_rank=48, kv_lora_rank=32, qk_nope_dim=32,
    qk_rope_dim=16, v_head_dim=32,
    mtp_depth=1, q_chunk=64,
)

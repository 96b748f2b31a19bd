"""jamba-1.5-large-398b  [hybrid]  72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave [arXiv:2403.19887; hf]

Period-8 pattern: one attention layer per 8 (the rest Mamba), MoE FFN on
every second layer.  The SSM layers use our Mamba2/SSD substrate (Jamba
ships Mamba-1; see DESIGN.md §Hardware-adaptation for the substitution)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=65536, act="swiglu",
    moe_experts=16, moe_top_k=2, moe_d_ff=24576, moe_every=2,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_conv=4, ssm_chunk=256,
    attn_every=8,
)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid",
    n_layers=8, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=512, act="swiglu",
    moe_experts=4, moe_top_k=2, moe_d_ff=128, moe_every=2,
    ssm_state=16, ssm_expand=2, ssm_headdim=32, ssm_conv=4, ssm_chunk=32,
    attn_every=8, q_chunk=64,
)

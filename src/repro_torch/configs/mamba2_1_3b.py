"""mamba2-1.3b  [ssm]  48L d_model=2048 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060; unverified]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_conv=4, ssm_chunk=256,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=128, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab=512,
    ssm_state=16, ssm_expand=2, ssm_headdim=32, ssm_conv=4, ssm_chunk=32,
)

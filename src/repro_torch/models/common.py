"""Shared model substrate (port of ``src/repro/models/common.py``): config,
norms, RoPE, the dense FFNs, chunked cross-entropy.

The reference's mesh machinery (``set_mesh_rules``, ``logical_sharding``,
``shard``, ``active_mesh``) exists for multi-device sharding and comes with
the port's multi-device slice; on one card ``shard`` is the identity, so
nothing here calls it.

Casts mirror the reference's: ``jnp.dot`` and ``jnp.einsum`` compute in
their operands' common dtype (``dot``, ``einsum`` below promote the same
way, where ``torch.matmul`` would refuse mixed operands), and every
``.astype`` of the reference stands at the same place here.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"          # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 512
    vocab: int = 1024
    act: str = "swiglu"            # swiglu | gelu
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5

    # MoE
    moe_experts: int = 0           # 0 = dense FFN everywhere
    moe_top_k: int = 2
    moe_d_ff: int = 0              # per-expert hidden (0 -> d_ff)
    moe_shared_experts: int = 0    # deepseek shared expert(s)
    moe_every: int = 1             # MoE FFN every k-th layer (jamba: 2)
    first_dense_layers: int = 0    # deepseek: first k layers use dense FFN
    capacity_factor: float = 1.25
    # 'global': sort-based dispatch.  'local' (the reference's replicated-
    # routing expert parallelism) needs a mesh; without one, as on one card,
    # it takes the global path, as the reference does.
    moe_impl: str = "global"

    # MLA (deepseek)
    mla: bool = False
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # SSM (mamba2)
    ssm_state: int = 0             # 0 = no ssm layers
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # hybrid (jamba): attention every `attn_every` layers, else mamba
    attn_every: int = 0            # 0 = all layers attention (or all ssm)

    # MTP (deepseek multi-token prediction)
    mtp_depth: int = 0

    # modality stub: number of leading positions fed by precomputed
    # frame/patch embeddings (llava / musicgen)
    frontend_tokens: int = 0

    # numerics
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16

    # attention chunking (memory control for long sequences)
    q_chunk: int = 1024
    kv_chunk: int = 1024

    # remat: activation checkpointing of each repetition of a segment's
    # pattern in training ("full" | "dots" | "none"; model.py).  unroll and
    # gather_bf16, the reference's scan and FSDP knobs, are kept for field
    # parity and change nothing on one card.
    remat: str = "full"
    unroll: bool = False
    gather_bf16: bool = False

    def layer_kind(self, i: int) -> str:
        """'attn' or 'ssm' mixer for layer i."""
        if self.ssm_state and not self.attn_every:
            return "ssm"
        if self.attn_every:
            return "attn" if i % self.attn_every == self.attn_every // 2 else "ssm"
        return "attn"

    def ffn_kind(self, i: int) -> str:
        """'dense' | 'moe' | 'none' FFN for layer i."""
        if self.family == "ssm":
            return "none"  # mamba2 blocks have no separate FFN
        if (self.moe_experts and i >= self.first_dense_layers
                and i % self.moe_every == (self.moe_every - 1)):
            return "moe"
        return "dense"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def n_params(self) -> int:
        """Total parameter count (approximate, matches init_params)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab
        total = V * d  # embed
        total += V * d  # lm head
        for i in range(self.n_layers):
            if self.layer_kind(i) == "attn":
                if self.mla:
                    total += d * self.q_lora_rank + self.q_lora_rank * self.n_heads * (
                        self.qk_nope_dim + self.qk_rope_dim)
                    total += d * (self.kv_lora_rank + self.qk_rope_dim)
                    total += self.kv_lora_rank * self.n_heads * (
                        self.qk_nope_dim + self.v_head_dim)
                    total += self.n_heads * self.v_head_dim * d
                else:
                    total += d * self.n_heads * self.head_dim
                    total += 2 * d * self.n_kv_heads * self.head_dim
                    total += self.n_heads * self.head_dim * d
            else:
                di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
                total += d * (2 * di + 2 * N + H) + di * d  # in/out proj
                total += self.ssm_conv * (di + 2 * N) + 2 * H + di
            k = self.ffn_kind(i)
            mult = 3 if self.act == "swiglu" else 2
            if k == "dense":
                total += mult * d * ff
            elif k == "moe":
                eff = self.moe_d_ff or ff
                total += self.moe_experts * mult * d * eff
                total += self.moe_shared_experts * mult * d * eff
                total += d * self.moe_experts
            total += 2 * d  # norms
        return total

    def n_active_params(self) -> int:
        """Params touched per token (MoE: top-k + shared only)."""
        if not self.moe_experts:
            return self.n_params()
        eff = self.moe_d_ff or self.d_ff
        mult = 3 if self.act == "swiglu" else 2
        dead = 0
        for i in range(self.n_layers):
            if self.ffn_kind(i) == "moe":
                dead += (self.moe_experts - self.moe_top_k) * mult * self.d_model * eff
        return self.n_params() - dead


# ---------------------------------------------------------------------------
# the reference's promotion rules
# ---------------------------------------------------------------------------
def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.dot``: a matmul in the operands' common dtype."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum``: the contraction in the operands' common dtype."""
    dt = functools.reduce(torch.promote_types, (o.dtype for o in ops))
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def randn(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """Standard normal draws times ``scale`` in fp32 on the generator's
    device, then cast to ``dtype`` (the reference's ``(normal * s).astype``)."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, H, D) with D even; positions: (..., S)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = positions[..., :, None].float() * inv[None, :]  # (..., S, D/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down) -> torch.Tensor:
    g = dot(x, w_gate)
    u = dot(x, w_up)
    return dot(F.silu(g) * u, w_down)


def gelu_mlp(x, w_up, w_down) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return dot(F.gelu(dot(x, w_up), approximate="tanh"), w_down)


def chunked_cross_entropy(h: torch.Tensor, head: torch.Tensor,
                          labels: torch.Tensor, *, chunk: int = 512,
                          unroll: bool = False) -> torch.Tensor:
    """Mean CE without materializing (B, S, V) logits: a loop over sequence
    chunks (the forward value; ``unroll`` is the reference's scan knob)."""
    B, S, d = h.shape
    nchunk = max(S // chunk, 1)
    chunk = S // nchunk
    h_c = h.reshape(B, nchunk, chunk, d)
    y_c = labels.reshape(B, nchunk, chunk)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(nchunk):
        logits = dot(h_c[:, i], head).float()                # (B, c, V)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, y_c[:, i, :, None].long())[..., 0]
        total = total + torch.sum(lse - tgt)
    return total / (B * S)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) without ``F.softplus``'s linear cut
    above 20."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


"""Mamba2 (SSD — state-space duality) mixer (port of
``src/repro/models/ssm.py``): the chunked quadratic-within-chunk /
recurrent-across-chunk form, and O(1) recurrent decode.

Projections are kept separate (x, z, B, C, dt).  The depthwise causal conv
is a sum of shifted scalings (width 4).  The inter-chunk recurrence, a
``lax.scan`` in the reference, is a loop over chunks.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (
    ModelConfig,
    dot,
    einsum,
    randn,
    rms_norm,
    softplus,
)


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (B, K-1, d_inner + 2N) rolling conv window (x|B|C)
    state: torch.Tensor  # (B, H, N, P) SSD recurrent state
    length: Any


def ssm_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    N, H, K = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    s = 1.0 / math.sqrt(d)
    pd = cfg.param_dtype
    dev = gen.device
    f32 = torch.float32
    return {
        "w_x": randn(gen, (d, di), s, pd),
        "w_z": randn(gen, (d, di), s, pd),
        "w_B": randn(gen, (d, N), s, pd),
        "w_C": randn(gen, (d, N), s, pd),
        "w_dt": randn(gen, (d, H), s, pd),
        "conv_w": randn(gen, (K, di + 2 * N), 0.1, pd),
        "conv_b": torch.zeros((di + 2 * N,), dtype=pd, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=f32,
                                          device=dev)),
        "D": torch.ones((H,), dtype=f32, device=dev),
        "dt_bias": torch.full((H,), -2.0, dtype=f32, device=dev),
        "norm": torch.ones((di,), dtype=pd, device=dev),
        "w_out": randn(gen, (di, d), 1.0 / math.sqrt(di), pd),
    }


def ssm_axes() -> dict:
    return {
        "w_x": ("embed", "ssm_inner"), "w_z": ("embed", "ssm_inner"),
        "w_B": ("embed", "ssm_state"), "w_C": ("embed", "ssm_state"),
        "w_dt": ("embed", None),
        "conv_w": (None, None), "conv_b": (None,),
        "A_log": (None,), "D": (None,), "dt_bias": (None,),
        "norm": ("ssm_inner",),
        "w_out": ("ssm_inner", "embed"),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal conv, x: (B, S, C), w: (K, C)."""
    K = w.shape[0]
    out = x * w[-1]
    for t in range(1, K):
        shifted = F.pad(x, (0, 0, t, 0))[:, :-t]
        out = out + shifted * w[-1 - t]
    return F.silu(out + b)


def _xbc(x: torch.Tensor, p) -> torch.Tensor:
    """The pre-conv inputs x | B | C."""
    return torch.cat([dot(x, p["w_x"]), dot(x, p["w_B"]), dot(x, p["w_C"])],
                     dim=-1)


def ssm_forward(cfg: ModelConfig, p, x: torch.Tensor,
                cache: SSMCache | None = None):
    B, S, d = x.shape
    if cache is not None and S == 1:
        return _ssm_decode(cfg, p, x, cache)

    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    Q = min(cfg.ssm_chunk, S)
    nc = max(S // Q, 1)
    Q = S // nc
    f32 = torch.float32

    z = dot(x, p["w_z"])
    raw = _xbc(x, p)
    # the cache's conv window: the last K-1 pre-conv inputs, kept from this
    # one computation (the reference computes the projections again for it,
    # and XLA's CSE merges the two)
    tailwin = raw[:, -(cfg.ssm_conv - 1):].clone() if cache is not None \
        else None
    xbc = _causal_conv(raw, p["conv_w"], p["conv_b"])
    del raw
    xin, Bp, Cp = xbc[..., :di], xbc[..., di:di + N], xbc[..., di + N:]

    dt = softplus(dot(x, p["w_dt"]).float() + p["dt_bias"])    # (B,S,H)
    A = -torch.exp(p["A_log"])                                  # (H,)

    xh = xin.reshape(B, nc, Q, H, P)
    Bc = Bp.reshape(B, nc, Q, N).float()
    Cc = Cp.reshape(B, nc, Q, N).float()
    dtc = dt.reshape(B, nc, Q, H)
    dA = dtc * A                                                # (B,nc,Q,H)
    cs = torch.cumsum(dA, dim=2)                                # within-chunk

    # ---- intra-chunk (attention-like dual form) ----
    # decay L[i,j] = exp(cs_i - cs_j), j <= i.  Mask BEFORE exp: for j > i
    # the difference is positive and exp overflows to inf.
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]          # (B,nc,Q,Q,H)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    diff = torch.where(mask[None, None, :, :, None], diff, -1e30)
    Ldec = torch.exp(diff)
    CB = einsum("bcqn,bckn->bcqk", Cc, Bc)                      # (B,nc,Q,Q)
    xdt = xh.float() * dtc[..., None]                           # (B,nc,Q,H,P)
    y_intra = einsum("bcqk,bcqkh,bckhp->bcqhp", CB, Ldec, xdt)

    # ---- chunk states + inter-chunk recurrence ----
    seg = torch.exp(cs[:, :, -1:, :] - cs)                      # (B,nc,Q,H)
    states = einsum("bckn,bckh,bckhp->bchnp", Bc, seg, xdt)
    chunk_decay = torch.exp(cs[:, :, -1, :])                    # (B,nc,H)

    h = (cache.state.float() if cache is not None
         else torch.zeros((B, H, N, P), dtype=f32, device=x.device))
    h_in = []
    for c in range(nc):
        h_in.append(h)                                          # entering c
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)                             # (B,nc,H,N,P)

    y_inter = einsum("bcqn,bcqh,bchnp->bcqhp", Cc, torch.exp(cs), h_in)
    y = (y_intra + y_inter).reshape(B, S, H, P)
    y = y + p["D"][None, None, :, None] * xin.reshape(B, S, H, P).float()
    y = y.reshape(B, S, di).to(x.dtype)

    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = dot(y, p["w_out"])

    new_cache = None
    if cache is not None:
        new_cache = SSMCache(
            conv=tailwin.to(cache.conv.dtype),
            state=h.to(cache.state.dtype),
            length=cache.length + S,
        )
    return out, new_cache


def _ssm_decode(cfg: ModelConfig, p, x: torch.Tensor, cache: SSMCache):
    B, _, d = x.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    x0 = x[:, 0]

    z = dot(x0, p["w_z"])
    raw = _xbc(x0, p)                                           # (B, C)
    dt_ = torch.promote_types(cache.conv.dtype, raw.dtype)
    win = torch.cat([cache.conv.to(dt_), raw[:, None].to(dt_)], dim=1)
    conv = einsum("bkc,kc->bc", win, p["conv_w"]) + p["conv_b"]
    xbc = F.silu(conv)
    xin, Bp, Cp = xbc[..., :di], xbc[..., di:di + N], xbc[..., di + N:]

    dt = softplus(dot(x0, p["w_dt"]).float() + p["dt_bias"])   # (B,H)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)                                      # (B,H)

    xh = xin.reshape(B, H, P).float()
    h = cache.state.float()
    h = h * dA[..., None, None] + einsum("bn,bh,bhp->bhnp", Bp.float(), dt, xh)
    y = einsum("bn,bhnp->bhp", Cp.float(), h)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(B, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = dot(y, p["w_out"])[:, None]

    new_cache = SSMCache(
        conv=win[:, 1:].to(cache.conv.dtype),
        state=h.to(cache.state.dtype),
        length=cache.length + 1,
    )
    return out, new_cache


def ssm_cache_init(cfg: ModelConfig, batch: int, dtype,
                   device=None) -> SSMCache:
    C = cfg.d_inner + 2 * cfg.ssm_state
    return SSMCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, C), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state,
                           cfg.ssm_headdim), dtype=torch.float32,
                          device=device),
        length=0,
    )

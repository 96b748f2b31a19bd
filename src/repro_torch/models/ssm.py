"""Mamba2 (SSD — state-space duality) mixer (port of
``src/repro/models/ssm.py``): the chunked quadratic-within-chunk /
recurrent-across-chunk form, and O(1) recurrent decode.

Projections are kept separate (x, z, B, C, dt).  The depthwise causal conv
is a sum of shifted scalings (width 4).  The inter-chunk recurrence, a
``lax.scan`` in the reference, is a loop over chunks.

On a mesh whose "model" axis splits ``ssm_inner`` (``ssm_axes``), each
model rank runs its share of the SSD heads: its columns of ``w_x``,
``w_z`` and ``norm``, its rows of ``w_out`` (a partial output, summed over
the model ranks), its heads' channels of the conv and of ``A_log``, ``D``,
``dt_bias`` and ``w_dt``.  B and C, which every head reads, are
column-parallel too: each rank projects its share of their ``2N``
channels and the shares are gathered.  The gated RMSNorm over
``ssm_inner`` takes its sum of squares over the model ranks, forward and
backward.  A cache's state holds this rank's heads; its conv window (the
last ``K - 1`` pre-conv inputs) is whole on every rank (``launch.steps``
gathers its few positions), so each rank gathers the x channels of the
new window.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (
    ModelConfig,
    Split,
    combine_model,
    dot,
    einsum,
    fan_out_model,
    gather_model,
    model_split,
    randn,
    rms_norm,
    share,
    softplus,
    sum_model,
    take,
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


def _weights(cfg: ModelConfig, p) -> tuple[Split, dict]:
    """(the split of the SSD heads, this rank's weights for them; the
    conv's as ``conv_w``/``conv_b`` over this rank's x | B | C)."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    hs = model_split(H, p["w_x"], 1, P)
    if not hs.on:
        return hs, p
    w = {k: take(hs, p[k], 1, P) for k in ("w_x", "w_z")}
    w["norm"] = take(hs, p["norm"], 0, P)
    w["w_out"] = take(hs, p["w_out"], 0, P)
    w["w_dt"] = take(hs, p["w_dt"], 1)
    for k in ("A_log", "D", "dt_bias"):
        w[k] = take(hs, p[k], 0)
    # B and C: each rank projects its share of the 2N channels
    w["bc"] = share(2 * N, hs.mesh)
    w["w_bc"] = take(w["bc"], torch.cat([p["w_B"], p["w_C"]], dim=-1), 1)
    w["conv_w"] = torch.cat([take(hs, p["conv_w"][:, :di], 1, P),
                             fan_out_model(p["conv_w"][:, di:], hs.mesh)], 1)
    w["conv_b"] = torch.cat([take(hs, p["conv_b"][:di], 0, P),
                             fan_out_model(p["conv_b"][di:], hs.mesh)])
    return hs, w


def _xbc(x: torch.Tensor, w, hs: Split) -> torch.Tensor:
    """The pre-conv inputs x | B | C (this rank's x channels)."""
    if not hs.on:
        return torch.cat([dot(x, w["w_x"]), dot(x, w["w_B"]),
                          dot(x, w["w_C"])], dim=-1)
    bc = gather_model(dot(x, w["w_bc"]), x.dim() - 1, w["bc"])
    return torch.cat([dot(x, w["w_x"]), bc], dim=-1)


def _gated_norm(cfg: ModelConfig, y, z, w, hs: Split) -> torch.Tensor:
    """Mamba2's gated RMSNorm, norm(y * silu(z)), over the whole
    ``ssm_inner``: split, its sum of squares is summed over the model
    ranks (forward and backward)."""
    if not hs.on:
        return rms_norm(y * F.silu(z), w["norm"], cfg.norm_eps)
    g = y * F.silu(z)
    dt = g.dtype
    g = g.float()
    var = sum_model((g * g).sum(-1, keepdim=True), hs.mesh) / cfg.d_inner
    return ((g * torch.rsqrt(var + cfg.norm_eps)) * w["norm"].float()).to(dt)


def _heads(t: torch.Tensor, dim: int, hs: Split, H: int) -> torch.Tensor:
    """A cache tensor's share of this rank's heads along ``dim``: as it is
    where the cache holds only them, else narrowed."""
    if hs.on and t.shape[dim] == H:
        return t.narrow(dim, hs.lo, hs.cnt)
    return t


def _window(cfg: ModelConfig, conv: torch.Tensor, hs: Split) -> torch.Tensor:
    """A whole conv window's channels of this rank's x | B | C."""
    if not hs.on:
        return conv
    di, P = cfg.d_inner, cfg.ssm_headdim
    return torch.cat([conv[..., hs.lo * P:(hs.lo + hs.cnt) * P],
                      conv[..., di:]], dim=-1)


def _whole_window(cfg: ModelConfig, win: torch.Tensor, hs: Split):
    """This rank's x | B | C window -> the whole window (the x channels
    gathered over the model ranks)."""
    if not hs.on:
        return win
    xw = win[..., :hs.cnt * cfg.ssm_headdim]
    return torch.cat([gather_model(xw, win.dim() - 1, hs, cfg.ssm_headdim),
                      win[..., hs.cnt * cfg.ssm_headdim:]], dim=-1)


def ssm_forward(cfg: ModelConfig, p, x: torch.Tensor,
                cache: SSMCache | None = None):
    B, S, d = x.shape
    if cache is not None and S == 1:
        return _ssm_decode(cfg, p, x, cache)

    N, P = cfg.ssm_state, cfg.ssm_headdim
    hs, w = _weights(cfg, p)
    H = hs.cnt
    di = H * P
    Q = min(cfg.ssm_chunk, S)
    nc = max(S // Q, 1)
    Q = S // nc
    f32 = torch.float32
    if hs.on:
        x = fan_out_model(x, hs.mesh)

    z = dot(x, w["w_z"])
    raw = _xbc(x, w, hs)
    # the cache's conv window: the last K-1 pre-conv inputs, kept from this
    # one computation (the reference computes the projections again for it,
    # and XLA's CSE merges the two)
    tailwin = raw[:, -(cfg.ssm_conv - 1):].clone() if cache is not None \
        else None
    xbc = _causal_conv(raw, w["conv_w"], w["conv_b"])
    del raw
    xin, Bp, Cp = xbc[..., :di], xbc[..., di:di + N], xbc[..., di + N:]

    dt = softplus(dot(x, w["w_dt"]).float() + w["dt_bias"])    # (B,S,H)
    A = -torch.exp(w["A_log"])                                  # (H,)

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

    h = (_heads(cache.state, 1, hs, cfg.ssm_heads).float()
         if cache is not None
         else torch.zeros((B, H, N, P), dtype=f32, device=x.device))
    h_in = []
    for c in range(nc):
        h_in.append(h)                                          # entering c
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)                             # (B,nc,H,N,P)

    y_inter = einsum("bcqn,bcqh,bchnp->bcqhp", Cc, torch.exp(cs), h_in)
    y = (y_intra + y_inter).reshape(B, S, H, P)
    y = y + w["D"][None, None, :, None] * xin.reshape(B, S, H, P).float()
    y = y.reshape(B, S, di).to(x.dtype)

    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = _gated_norm(cfg, y, z, w, hs)
    out = dot(y, w["w_out"])
    if hs.on:
        out = combine_model(out, hs.mesh)

    new_cache = None
    if cache is not None:
        new_cache = SSMCache(
            conv=_whole_window(cfg, tailwin, hs).to(cache.conv.dtype),
            state=_state_out(h, cache.state, hs, cfg.ssm_heads),
            length=cache.length + S,
        )
    return out, new_cache


def _state_out(h: torch.Tensor, old: torch.Tensor, hs: Split, H: int):
    """This rank's heads' new state, laid out as the cache's ``old`` state
    (gathered over the model ranks where it holds every head)."""
    if hs.on and old.shape[1] == H:
        h = gather_model(h, 1, hs)
    return h.to(old.dtype)


def _ssm_decode(cfg: ModelConfig, p, x: torch.Tensor, cache: SSMCache):
    B, _, d = x.shape
    N, P = cfg.ssm_state, cfg.ssm_headdim
    hs, w = _weights(cfg, p)
    H = hs.cnt
    di = H * P
    x0 = x[:, 0]
    if hs.on:
        x0 = fan_out_model(x0, hs.mesh)

    z = dot(x0, w["w_z"])
    raw = _xbc(x0, w, hs)                                       # (B, C)
    conv_c = _window(cfg, cache.conv, hs)
    dt_ = torch.promote_types(conv_c.dtype, raw.dtype)
    win = torch.cat([conv_c.to(dt_), raw[:, None].to(dt_)], dim=1)
    conv = einsum("bkc,kc->bc", win, w["conv_w"]) + w["conv_b"]
    xbc = F.silu(conv)
    xin, Bp, Cp = xbc[..., :di], xbc[..., di:di + N], xbc[..., di + N:]

    dt = softplus(dot(x0, w["w_dt"]).float() + w["dt_bias"])   # (B,H)
    A = -torch.exp(w["A_log"])
    dA = torch.exp(dt * A)                                      # (B,H)

    xh = xin.reshape(B, H, P).float()
    h = _heads(cache.state, 1, hs, cfg.ssm_heads).float()
    h = h * dA[..., None, None] + einsum("bn,bh,bhp->bhnp", Bp.float(), dt, xh)
    y = einsum("bn,bhnp->bhp", Cp.float(), h)
    y = y + w["D"][None, :, None] * xh
    y = y.reshape(B, di).to(x.dtype)
    y = _gated_norm(cfg, y, z, w, hs)
    out = dot(y, w["w_out"])
    if hs.on:
        out = combine_model(out, hs.mesh)
    out = out[:, None]

    new_cache = SSMCache(
        conv=_whole_window(cfg, win[:, 1:], hs).to(cache.conv.dtype),
        state=_state_out(h, cache.state, hs, cfg.ssm_heads),
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

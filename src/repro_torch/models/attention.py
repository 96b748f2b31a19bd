"""Attention mixers (port of ``src/repro/models/attention.py``): GQA/MQA/MHA
and MLA (deepseek), with causal chunked prefill (exact triangular FLOPs,
bounded memory) and single-token decode against a KV cache.

Chunking: the query axis is processed in static chunks; chunk i attends to
keys [0, (i+1)*chunk) with one matmul, so only the triangular work is done
while peak memory is one chunk's logits.

A cache ``length`` (and a write index) is a Python int, a 0-d tensor, or a
``(B,)`` tensor of per-row lengths.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.common import ModelConfig, dot, einsum, randn, rope


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, T, Hkv, hd)   — GQA;  MLA: c_kv (B, T, kv_lora)
    v: torch.Tensor  # (B, T, Hkv, hd)   — GQA;  MLA: k_rope (B, T, rope_dim)
    length: Any      # number of valid positions


def _valid(T: int, length, B: int, device) -> torch.Tensor:
    """(B, T) mask of each row's valid prefix (an int length is compared
    as a scalar: no host-to-device copy)."""
    pos = torch.arange(T, device=device)
    if isinstance(length, torch.Tensor):
        return (pos[None, :] < length.to(device).reshape(-1, 1)).expand(B, T)
    return (pos < length)[None, :].expand(B, T)


def _sdpa_chunked(q, k, v, n_kv_groups: int, q_chunk: int, scale: float):
    """Causal attention, q: (B,S,H,hd), k/v: (B,S,Hkv,hd).  Exact-FLOP
    chunking: a loop over static q-chunks."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    q = q.reshape(B, S, Hkv, n_kv_groups, hd)
    nchunk = max(1, S // q_chunk)
    cq = S // nchunk
    outs = []
    for i in range(nchunk):
        qi = q[:, i * cq:(i + 1) * cq]                 # (B,cq,Hkv,G,hd)
        kv_hi = (i + 1) * cq
        ki = k[:, :kv_hi]                              # (B,T,Hkv,hd)
        vi = v[:, :kv_hi]
        logits = einsum("bqkgd,btkd->bkgqt", qi, ki).float() * scale
        # causal mask inside the diagonal block
        qpos = i * cq + torch.arange(cq, device=q.device)
        kpos = torch.arange(kv_hi, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        logits = torch.where(mask[None, None, None], logits, -1e30)
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        outs.append(einsum("bkgqt,btkd->bqkgd", w, vi))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out.reshape(B, S, H, v.shape[-1])  # v dim may differ from qk dim (MLA)


def _sdpa_decode(q, k, v, n_kv_groups: int, scale: float, length):
    """q: (B,1,H,hd) against cache k/v: (B,T,Hkv,hd).
    length: scalar or (B,) valid-prefix length(s)."""
    B, _, H, hd = q.shape
    Hkv = k.shape[2]
    T = k.shape[1]
    qg = q.reshape(B, Hkv, n_kv_groups, hd)
    logits = einsum("bkgd,btkd->bkgt", qg, k).float() * scale
    valid = _valid(T, length, B, q.device)[:, None, None, :]
    logits = torch.where(valid, logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = einsum("bkgt,btkd->bkgd", w, v)
    return out.reshape(B, 1, H, v.shape[-1])


def _cache_write(cache_arr, new_vals, idx):
    """A copy of ``cache_arr`` with new_vals (B, 1, ...) written at position
    idx of every row.  A scalar idx is ``dynamic_update_slice``'s, clamped
    so the write fits; a (B,) idx writes each row at its own position."""
    out = cache_arr.clone()
    if not isinstance(idx, torch.Tensor):
        i = min(max(int(idx), 0), cache_arr.shape[1] - 1)
        out[:, i:i + 1] = new_vals.to(cache_arr.dtype)
        return out
    if idx.dim() == 0:  # clamped on the device: no read on the host
        i = idx.to(cache_arr.device, torch.long).clamp(
            0, cache_arr.shape[1] - 1).reshape(1)
        return out.index_copy_(1, i, new_vals.to(cache_arr.dtype))
    B = cache_arr.shape[0]
    rows = torch.arange(B, device=cache_arr.device)
    out[rows, idx.to(cache_arr.device)] = new_vals[:, 0].to(cache_arr.dtype)
    return out


def _prefill_write(cache_arr, vals):
    """A copy of ``cache_arr`` with vals written from position 0 (prefill
    starts from an empty cache, as in the reference)."""
    out = cache_arr.clone()
    out[:, :vals.shape[1]] = vals.to(cache_arr.dtype)
    return out


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------
def gqa_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = 1.0 / math.sqrt(d)
    so = 1.0 / math.sqrt(H * hd)
    pd = cfg.param_dtype
    return {
        "wq": randn(gen, (d, H * hd), s, pd),
        "wk": randn(gen, (d, Hkv * hd), s, pd),
        "wv": randn(gen, (d, Hkv * hd), s, pd),
        "wo": randn(gen, (H * hd, d), so, pd),
    }


def gqa_axes() -> dict:
    return {
        "wq": ("embed", "heads"),
        "wk": ("embed", "kv_heads"),
        "wv": ("embed", "kv_heads"),
        "wo": ("heads", "embed"),
    }


def gqa_forward(cfg: ModelConfig, p, x: torch.Tensor,
                positions: torch.Tensor, cache: KVCache | None = None):
    B, S, d = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = dot(x, p["wq"]).reshape(B, S, H, hd)
    k = dot(x, p["wk"]).reshape(B, S, Hkv, hd)
    v = dot(x, p["wv"]).reshape(B, S, Hkv, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    scale = 1.0 / math.sqrt(hd)
    groups = H // Hkv
    if cache is None:
        out = _sdpa_chunked(q, k, v, groups, cfg.q_chunk, scale)
        new_cache = None
    elif S == 1:
        # decode: append to cache, attend over the valid prefix
        ck = _cache_write(cache.k, k, cache.length)
        cv = _cache_write(cache.v, v, cache.length)
        new_cache = KVCache(ck, cv, cache.length + 1)
        out = _sdpa_decode(q, ck, cv, groups, scale, cache.length + 1)
    else:
        # prefill into an empty cache
        ck = _prefill_write(cache.k, k)
        cv = _prefill_write(cache.v, v)
        new_cache = KVCache(ck, cv, cache.length + S)
        out = _sdpa_chunked(q, k, v, groups, cfg.q_chunk, scale)
    out = out.reshape(B, S, H * hd)
    return dot(out, p["wo"]), new_cache


def gqa_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device=None) -> KVCache:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=0,
    )


# ---------------------------------------------------------------------------
# MLA (deepseek-v3): low-rank compressed q/kv, latent KV cache, absorbed decode
# ---------------------------------------------------------------------------
def mla_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    pd = cfg.param_dtype

    def s(f):
        return 1.0 / math.sqrt(f)

    return {
        "wq_a": randn(gen, (d, r_q), s(d), pd),
        "wq_b": randn(gen, (r_q, H * (dn + dr)), s(r_q), pd),
        "wkv_a": randn(gen, (d, r_kv + dr), s(d), pd),
        "wk_b": randn(gen, (r_kv, H * dn), s(r_kv), pd),
        "wv_b": randn(gen, (r_kv, H * dv), s(r_kv), pd),
        "wo": randn(gen, (H * dv, d), s(H * dv), pd),
    }


def mla_axes() -> dict:
    return {
        "wq_a": ("embed", "lora"),
        "wq_b": ("lora", "heads"),
        "wkv_a": ("embed", "lora"),
        "wk_b": ("lora", "heads"),
        "wv_b": ("lora", "heads"),
        "wo": ("heads", "embed"),
    }


def mla_forward(cfg: ModelConfig, p, x: torch.Tensor,
                positions: torch.Tensor, cache: KVCache | None = None):
    B, S, d = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r_kv = cfg.kv_lora_rank
    scale = 1.0 / math.sqrt(dn + dr)

    q = dot(dot(x, p["wq_a"]), p["wq_b"]).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)

    kv = dot(x, p["wkv_a"])                          # (B, S, r_kv + dr)
    c_kv, k_rope = kv[..., :r_kv], kv[..., r_kv:]
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]

    if cache is None or S > 1:
        # prefill / train: expand the latent into per-head K/V
        k_nope = dot(c_kv, p["wk_b"]).reshape(B, S, H, dn)
        vv = dot(c_kv, p["wv_b"]).reshape(B, S, H, dv)
        k_full = torch.cat(
            [k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        out = _sdpa_chunked(q_full, k_full, vv, 1, cfg.q_chunk, scale)
        new_cache = None
        if cache is not None:
            # prefill writes the cache at offset 0: it starts empty
            ck = _prefill_write(cache.k, c_kv)
            cr = _prefill_write(cache.v, k_rope)
            new_cache = KVCache(ck, cr, cache.length + S)
    else:
        # absorbed decode: score/combine directly in the latent space
        ck = _cache_write(cache.k, c_kv, cache.length)
        cr = _cache_write(cache.v, k_rope, cache.length)
        new_cache = KVCache(ck, cr, cache.length + 1)
        T = ck.shape[1]
        wk_b = p["wk_b"].reshape(r_kv, H, dn)
        q_lat = einsum("bhd,rhd->bhr", q_nope[:, 0], wk_b)        # (B,H,r_kv)
        logits = einsum("bhr,btr->bht", q_lat, ck).float()
        logits = logits + einsum("bhd,btd->bht", q_rope[:, 0], cr).float()
        logits = logits * scale
        valid = _valid(T, cache.length + 1, B, x.device)[:, None, :]
        logits = torch.where(valid, logits, -1e30)
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        o_lat = einsum("bht,btr->bhr", w, ck)                     # (B,H,r_kv)
        wv_b = p["wv_b"].reshape(r_kv, H, dv)
        out = einsum("bhr,rhd->bhd", o_lat, wv_b)[:, None]        # (B,1,H,dv)
    out = out.reshape(B, S, H * dv)
    return dot(out, p["wo"]), new_cache


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device=None) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                      device=device),
        length=0,
    )

"""Attention mixers (port of ``src/repro/models/attention.py``): GQA/MQA/MHA
and MLA (deepseek), with causal chunked prefill (exact triangular FLOPs,
bounded memory) and single-token decode against a KV cache.

Chunking: the query axis is processed in static chunks; chunk i attends to
keys [0, (i+1)*chunk) with one matmul, so only the triangular work is done
while peak memory is one chunk's logits.

A cache ``length`` (and a write index) is a Python int, a 0-d tensor, or a
``(B,)`` tensor of per-row lengths.

On a mesh whose "model" axis splits the heads, each model rank projects
and attends with its own query heads (``wq`` / MLA's ``wq_b``, ``wk_b``,
``wv_b`` by heads) and its share of ``wo`` gives a partial output, summed
over the model ranks.  ``wk`` and ``wv`` (and MLA's low-rank ``wq_a``,
``wkv_a``) stay whole on every rank (``"kv_heads"`` and ``"lora"`` are
not split): a rank computes K and V for the KV heads its query heads read
(for all of them where it writes a cache, which holds every KV head), as
GSPMD partitions the reference's program, and attends with its heads'
groups.  Where
the rules split a cache's positions (``common.position_axes``:
``decode_32k`` puts them on "model"), each rank holds its block of
positions: a new token's K and V are written on the rank that owns its
position, and a decode step attends every head over each rank's own
positions and merges the ranks' partial (max, sum, weighted V) by their
log-sum-exp; no rank gathers the cache.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.models.common import (
    ModelConfig,
    Split,
    active_mesh,
    axes_rank,
    axes_size,
    combine_model,
    dot,
    einsum,
    fan_out_model,
    gather_model,
    max_over,
    model_split,
    position_axes,
    randn,
    rope,
    sum_over,
    take,
)


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, T, Hkv, hd)   — GQA;  MLA: c_kv (B, T, kv_lora)
    v: torch.Tensor  # (B, T, Hkv, hd)   — GQA;  MLA: k_rope (B, T, rope_dim)
    length: Any      # number of valid positions


@dataclass(frozen=True)
class _Positions:
    """A cache's positions split over ``axes`` of ``mesh`` (``n`` ranks):
    this rank holds the ``T`` from ``offset`` on."""
    mesh: Any
    axes: tuple
    n: int
    T: int
    offset: int


def _positions(T: int) -> _Positions | None:
    """How the active mesh's rules split the positions of a cache whose
    rank holds ``T`` of them (None: every rank holds all of them)."""
    mesh = active_mesh()
    axes = position_axes(mesh)
    n = axes_size(mesh, axes) if mesh is not None else 1
    if n == 1:
        return None
    return _Positions(mesh, axes, n, T, axes_rank(mesh, axes) * T)


def _valid(T: int, length, B: int, device, offset: int = 0) -> torch.Tensor:
    """(B, T) mask of each row's valid prefix (an int length is compared
    as a scalar: no host-to-device copy), for the positions from
    ``offset`` on."""
    pos = torch.arange(offset, offset + T, device=device)
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


def _merge(logits, weighted, pos: _Positions) -> torch.Tensor:
    """Softmax over the positions of every rank of ``pos`` against them:
    ``weighted(w)`` contracts this rank's unnormalized weights with its
    values; the ranks' maxima, sums and weighted values merge by the
    log-sum-exp (fp32; decode only, no gradient)."""
    m = max_over(logits.amax(-1, keepdim=True), pos.mesh, pos.axes)
    w = torch.exp(logits - m)
    o = weighted(w).float()
    so = sum_over(torch.cat([o, w.sum(-1)[..., None]], dim=-1),
                  pos.mesh, pos.axes)
    return so[..., :-1] / so[..., -1:]


def _sdpa_decode(q, k, v, n_kv_groups: int, scale: float, length,
                 pos: _Positions | None = None):
    """q: (B,1,H,hd) against cache k/v: (B,T,Hkv,hd).
    length: scalar or (B,) valid-prefix length(s).  ``pos``: the cache
    holds this rank's block of positions (merged over the ranks)."""
    B, _, H, hd = q.shape
    Hkv = k.shape[2]
    T = k.shape[1]
    qg = q.reshape(B, Hkv, n_kv_groups, hd)
    logits = einsum("bkgd,btkd->bkgt", qg, k).float() * scale
    valid = _valid(T, length, B, q.device,
                   pos.offset if pos else 0)[:, None, None, :]
    logits = torch.where(valid, logits, -1e30)
    if pos is not None:
        out = _merge(logits, lambda w: einsum("bkgt,btkd->bkgd",
                                              w.to(v.dtype), v), pos)
        return out.to(v.dtype).reshape(B, 1, H, v.shape[-1])
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = einsum("bkgt,btkd->bkgd", w, v)
    return out.reshape(B, 1, H, v.shape[-1])


def _cache_write(cache_arr, new_vals, idx, pos: _Positions | None = None):
    """A copy of ``cache_arr`` with new_vals (B, 1, ...) written at position
    idx of every row.  A scalar idx is ``dynamic_update_slice``'s, clamped
    so the write fits; a (B,) idx writes each row at its own position.
    ``pos``: the cache holds this rank's block of positions, and the write
    lands only on the rank that owns the (clamped) position."""
    out = cache_arr.clone()
    T = cache_arr.shape[1]
    if pos is None:
        if not isinstance(idx, torch.Tensor):
            i = min(max(int(idx), 0), T - 1)
            out[:, i:i + 1] = new_vals.to(cache_arr.dtype)
            return out
        if idx.dim() == 0:  # clamped on the device: no read on the host
            i = idx.to(cache_arr.device, torch.long).clamp(0, T - 1).reshape(1)
            return out.index_copy_(1, i, new_vals.to(cache_arr.dtype))
        B = cache_arr.shape[0]
        rows = torch.arange(B, device=cache_arr.device)
        out[rows, idx.to(cache_arr.device)] = new_vals[:, 0].to(cache_arr.dtype)
        return out
    new = new_vals.to(cache_arr.dtype)
    if not isinstance(idx, torch.Tensor):
        i = min(max(int(idx), 0), pos.n * T - 1) - pos.offset
        if 0 <= i < T:
            out[:, i:i + 1] = new
        return out
    g = idx.to(cache_arr.device, torch.long)
    if g.dim() == 0:
        g = g.clamp(0, pos.n * T - 1)
    g = g - pos.offset
    own = (g >= 0) & (g < T)
    i = g.clamp(0, T - 1)
    if g.dim() == 0:
        i = i.reshape(1)
        kept = torch.where(own, new, out.index_select(1, i))
        return out.index_copy_(1, i, kept)
    rows = torch.arange(cache_arr.shape[0], device=cache_arr.device)
    mask = own.reshape((-1,) + (1,) * (new.dim() - 2))
    out[rows, i] = torch.where(mask, new[:, 0], out[rows, i])
    return out


def _prefill_write(cache_arr, vals, pos: _Positions | None = None):
    """A copy of ``cache_arr`` with vals written from position 0 (prefill
    starts from an empty cache, as in the reference); ``pos``: this
    rank's block of those positions."""
    out = cache_arr.clone()
    off = pos.offset if pos is not None else 0
    n = max(min(vals.shape[1] - off, cache_arr.shape[1]), 0)
    out[:, :n] = vals[:, off:off + n].to(cache_arr.dtype)
    return out


def _kv_share(hs: Split, G: int, n_kv: int) -> Split:
    """The K/V heads this rank's query heads ``[hs.lo, hs.lo + hs.cnt)``
    read (``G`` queries per K/V head, ``n_kv`` K/V heads)."""
    lo = min(hs.lo // G, n_kv)
    hi = (hs.lo + hs.cnt - 1) // G + 1 if hs.cnt else lo
    return Split(n_kv, lo, hi - lo, hs.mesh)


def _kv_groups(k, v, hs: Split, G: int, k0: int = 0):
    """The K/V heads that this rank's query heads ``[hs.lo, hs.lo +
    hs.cnt)`` attend with (the heads' dim 2 of ``k`` and ``v``, which hold
    the K/V heads from ``k0`` on), and the queries per K/V head: whole
    groups where the share holds whole groups, the one K/V head of a share
    inside one group, else each query head's own K/V head."""
    if not hs.on:
        return k, v, G
    lo, cnt = hs.lo, hs.cnt
    a = lo // G - k0
    if lo % G == 0 and cnt % G == 0:
        return k[:, :, a:a + cnt // G], v[:, :, a:a + cnt // G], G
    if lo // G == (lo + cnt - 1) // G:
        return k[:, :, a:a + 1], v[:, :, a:a + 1], cnt
    idx = torch.arange(lo, lo + cnt, device=k.device) // G - k0
    return k.index_select(2, idx), v.index_select(2, idx), 1


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
    hs = model_split(H, p["wq"], 1, hd)
    if hs.on:
        x = fan_out_model(x, hs.mesh)
    scale = 1.0 / math.sqrt(hd)
    groups = H // Hkv
    # the K/V heads computed: those this rank's heads read in training, all
    # of them for a cache (every rank holds every K/V head of its positions)
    kvs = _kv_share(hs, groups, Hkv) if cache is None and hs.on else \
        Split(Hkv, 0, Hkv, hs.mesh)
    q = dot(x, take(hs, p["wq"], 1, hd)).reshape(B, S, hs.cnt, hd)
    k = dot(x, take(kvs, p["wk"], 1, hd)).reshape(B, S, kvs.cnt, hd)
    v = dot(x, take(kvs, p["wv"], 1, hd)).reshape(B, S, kvs.cnt, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cache is None:
        out = _sdpa_chunked(q, *_kv_groups(k, v, hs, groups, kvs.lo),
                            cfg.q_chunk, scale)
        new_cache = None
    elif S == 1:
        # decode: append to cache, attend over the valid prefix
        pos = _positions(cache.k.shape[1])
        ck = _cache_write(cache.k, k, cache.length, pos)
        cv = _cache_write(cache.v, v, cache.length, pos)
        new_cache = KVCache(ck, cv, cache.length + 1)
        if pos is None:
            ckl, cvl, g = _kv_groups(ck, cv, hs, groups)
            out = _sdpa_decode(q, ckl, cvl, g, scale, cache.length + 1)
        else:  # every head over this rank's positions, then its own heads
            out = _sdpa_decode(gather_model(q, 2, hs), ck, cv, groups, scale,
                               cache.length + 1, pos)
            out = out[:, :, hs.lo:hs.lo + hs.cnt]
    else:
        # prefill into an empty cache
        pos = _positions(cache.k.shape[1])
        ck = _prefill_write(cache.k, k, pos)
        cv = _prefill_write(cache.v, v, pos)
        new_cache = KVCache(ck, cv, cache.length + S)
        out = _sdpa_chunked(q, *_kv_groups(k, v, hs, groups), cfg.q_chunk,
                            scale)
    out = dot(out.reshape(B, S, hs.cnt * hd), take(hs, p["wo"], 0, hd))
    if hs.on:
        out = combine_model(out, hs.mesh)
    return out, new_cache


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
    hs = model_split(H, p["wq_b"], 1, dn + dr)
    h = hs.cnt
    if hs.on:
        x = fan_out_model(x, hs.mesh)

    wq_a, wkv_a = (fan_out_model(p[k], hs.mesh) if hs.on else p[k]
                   for k in ("wq_a", "wkv_a"))    # whole: "lora" not split
    q = dot(dot(x, wq_a), take(hs, p["wq_b"], 1, dn + dr)
            ).reshape(B, S, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)

    kv = dot(x, wkv_a)                               # (B, S, r_kv + dr)
    c_kv, k_rope = kv[..., :r_kv], kv[..., r_kv:]
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    wk_b = take(hs, p["wk_b"], 1, dn)
    wv_b = take(hs, p["wv_b"], 1, dv)

    if cache is None or S > 1:
        # prefill / train: expand the latent into per-head K/V
        k_nope = dot(c_kv, wk_b).reshape(B, S, h, dn)
        vv = dot(c_kv, wv_b).reshape(B, S, h, dv)
        k_full = torch.cat(
            [k_nope, k_rope[:, :, None, :].expand(B, S, h, dr)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        out = _sdpa_chunked(q_full, k_full, vv, 1, cfg.q_chunk, scale)
        new_cache = None
        if cache is not None:
            # prefill writes the cache at offset 0: it starts empty
            pos = _positions(cache.k.shape[1])
            ck = _prefill_write(cache.k, c_kv, pos)
            cr = _prefill_write(cache.v, k_rope, pos)
            new_cache = KVCache(ck, cr, cache.length + S)
    else:
        # absorbed decode: score/combine directly in the latent space
        pos = _positions(cache.k.shape[1])
        ck = _cache_write(cache.k, c_kv, cache.length, pos)
        cr = _cache_write(cache.v, k_rope, cache.length, pos)
        new_cache = KVCache(ck, cr, cache.length + 1)
        T = ck.shape[1]
        q_lat = einsum("bhd,rhd->bhr", q_nope[:, 0],
                       wk_b.reshape(r_kv, h, dn))                  # (B,h,r_kv)
        qr = q_rope[:, 0]
        if pos is not None:  # every head over this rank's positions
            q_lat, qr = gather_model(q_lat, 1, hs), gather_model(qr, 1, hs)
        logits = einsum("bhr,btr->bht", q_lat, ck).float()
        logits = logits + einsum("bhd,btd->bht", qr, cr).float()
        logits = logits * scale
        valid = _valid(T, cache.length + 1, B, x.device,
                       pos.offset if pos else 0)[:, None, :]
        logits = torch.where(valid, logits, -1e30)
        if pos is None:
            w = torch.softmax(logits, dim=-1).to(x.dtype)
            o_lat = einsum("bht,btr->bhr", w, ck)                 # (B,h,r_kv)
        else:
            o_lat = _merge(logits, lambda w: einsum(
                "bht,btr->bhr", w.to(x.dtype), ck), pos).to(x.dtype)
            o_lat = o_lat[:, hs.lo:hs.lo + h]
        out = einsum("bhr,rhd->bhd", o_lat,
                     wv_b.reshape(r_kv, h, dv))[:, None]          # (B,1,h,dv)
    out = dot(out.reshape(B, S, h * dv), take(hs, p["wo"], 0, dv))
    if hs.on:
        out = combine_model(out, hs.mesh)
    return out, new_cache


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device=None) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                      device=device),
        length=0,
    )

"""Mixture-of-Experts FFN with sort-based capacity dispatch (port of
``src/repro/models/moe.py``'s ``"global"`` path).

Dispatch is static-shaped: the N*k (token, expert) assignments are sorted by
expert id, each assignment gets a rank within its expert, assignments beyond
the per-expert capacity C go to an overflow slot and are dropped, kept
tokens are scattered into an (E, C, d) buffer, the expert GEMMs run as one
batched einsum, and results are combined back with the router gates.

The reference's ``moe_impl="local"`` (replicated-routing expert parallelism
over a mesh's "model" axis) takes the global path when no mesh is active,
as on one card; ``moe_forward_local`` comes with the multi-device slice.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, dot, einsum, randn


def moe_params(cfg: ModelConfig, gen: torch.Generator, *,
               n_experts: int | None = None) -> dict:
    d = cfg.d_model
    eff = cfg.moe_d_ff or cfg.d_ff
    E = n_experts if n_experts is not None else cfg.moe_experts
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(eff)
    pd = cfg.param_dtype
    p = {
        "router": randn(gen, (d, E), s_in, torch.float32),
        "w_gate": randn(gen, (E, d, eff), s_in, pd),
        "w_up": randn(gen, (E, d, eff), s_in, pd),
        "w_down": randn(gen, (E, eff, d), s_out, pd),
    }
    if cfg.moe_shared_experts:
        m = cfg.moe_shared_experts
        p["shared_gate"] = randn(gen, (d, m * eff), s_in, pd)
        p["shared_up"] = randn(gen, (d, m * eff), s_in, pd)
        p["shared_down"] = randn(gen, (m * eff, d), s_out, pd)
    return p


def moe_forward(cfg: ModelConfig, p, x: torch.Tensor):
    """x: (B, S, d) -> (out, aux_loss).  Every ``moe_impl`` takes the
    global path on one card (no mesh)."""
    return _moe_forward_global(cfg, p, x)


def _route(cfg: ModelConfig, p, xt: torch.Tensor):
    """Router in fp32: (probs (N, E), renormalised top-k gates (N, k),
    expert ids (N, k))."""
    logits = dot(xt.float(), p["router"])                      # (N, E)
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, cfg.moe_top_k, dim=-1)       # (N, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, eidx


def _moe_forward_global(cfg: ModelConfig, p, x: torch.Tensor):
    """x: (B, S, d) -> (out, aux_loss)."""
    B, S, d = x.shape
    E, k = p["w_gate"].shape[0], cfg.moe_top_k
    N = B * S
    dev = x.device
    xt = x.reshape(N, d)
    probs, gate, eidx = _route(cfg, p, xt)

    # load-balancing aux loss (Switch-style)
    me = probs.mean(dim=0)                                     # (E,)
    ce = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, eidx.reshape(-1),
        torch.ones(N * k, dtype=torch.float32, device=dev)) / (N * k)
    aux = E * torch.sum(me * ce)

    # --- sort-based dispatch -------------------------------------------------
    NK = N * k
    cap = int(math.ceil(NK / E * cfg.capacity_factor))
    flat_e = eidx.reshape(NK)
    flat_g = gate.reshape(NK)
    ar = torch.arange(NK, device=dev)
    tok_of = ar // k                                           # token index

    order = torch.argsort(flat_e, stable=True)                 # (NK,)
    e_sorted = flat_e[order]
    # rank within expert: position - start offset of that expert's segment
    start = torch.searchsorted(e_sorted, torch.arange(E, device=dev),
                               side="left")                    # (E,)
    rank = ar - start[e_sorted]
    keep = rank < cap
    slot = torch.where(keep, e_sorted * cap + rank, E * cap)   # overflow slot

    buf = torch.zeros((E * cap + 1, d), dtype=x.dtype, device=dev)
    buf[slot] = xt[tok_of[order]]
    buf = buf[:-1].reshape(E, cap, d)

    # --- expert FFN (batched over E) -----------------------------------------
    g = einsum("ecd,edf->ecf", buf, p["w_gate"])
    u = einsum("ecd,edf->ecf", buf, p["w_up"])
    h = F.silu(g) * u
    out_e = einsum("ecf,efd->ecd", h, p["w_down"])             # (E, cap, d)

    # --- combine --------------------------------------------------------------
    out_flat = out_e.reshape(E * cap, d)
    gathered = torch.where(keep[:, None],
                           out_flat[torch.clamp(slot, 0, E * cap - 1)], 0.0)
    contrib = gathered * flat_g[order][:, None].to(x.dtype)
    out = torch.zeros((N, d), dtype=x.dtype, device=dev).index_add_(
        0, tok_of[order], contrib.to(x.dtype))

    if "shared_gate" in p:
        sg = dot(xt, p["shared_gate"])
        su = dot(xt, p["shared_up"])
        out = out + dot(F.silu(sg) * su, p["shared_down"])

    return out.reshape(B, S, d), aux

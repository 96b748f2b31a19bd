"""Mixture-of-Experts FFN with sort-based capacity dispatch (port of
``src/repro/models/moe.py``).

Dispatch is static-shaped: the N*k (token, expert) assignments are sorted by
expert id, each assignment gets a rank within its expert, assignments beyond
the per-expert capacity C go to an overflow slot and are dropped, kept
tokens are scattered into an (E, C, d) buffer, the expert GEMMs run as one
batched einsum, and results are combined back with the router gates.

Two dispatches, by ``cfg.moe_impl``:

  * ``"global"`` pools capacity, and the load-balancing aux loss, over the
    whole batch, as the reference's GSPMD program does on any mesh: on a
    batch split over the data axes it all-gathers the tokens in rank order,
    dispatches them all, and keeps its own rows of the output;
  * ``"local"`` (``moe_forward_local``, under an active mesh with a
    ``"model"`` axis): each model rank routes its data shard whole, keeps
    only the tokens of its ``E // n_mp`` experts at the per-shard capacity,
    and one sum over ``"model"`` combines the outputs.

Expert weights (``EXPERT_WEIGHTS``) may arrive as DTensors laid out by
``moe_axes`` (experts over ``"model"``, d_model over the data axes): each
path gathers them as it needs (``common.whole``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.models.common import (
    ModelConfig,
    active_mesh,
    combine_model,
    data_rank,
    data_size,
    dot,
    einsum,
    fan_out_model,
    gather_rows,
    mean_data,
    randn,
    whole,
)

#: the per-expert weights, (E, ...) with experts leading
EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")


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


def moe_axes(cfg: ModelConfig) -> dict:
    ax = {
        "router": ("embed", None),
        "w_gate": ("experts", "embed", "expert_mlp"),
        "w_up": ("experts", "embed", "expert_mlp"),
        "w_down": ("experts", "expert_mlp", "embed"),
    }
    if cfg.moe_shared_experts:
        ax["shared_gate"] = ("embed", "mlp")
        ax["shared_up"] = ("embed", "mlp")
        ax["shared_down"] = ("mlp", "embed")
    return ax


def moe_forward(cfg: ModelConfig, p, x: torch.Tensor):
    """x: (B, S, d) -> (out, aux_loss).  Dispatch impl per cfg.moe_impl;
    under an active mesh ``x`` holds this data rank's rows."""
    if cfg.moe_impl == "local":
        mesh = active_mesh()
        if mesh is not None and "model" in mesh.mesh_dim_names:
            return moe_forward_local(cfg, p, x, mesh)
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
    """x: (B, S, d) -> (out, aux_loss).  Under an active mesh with data
    axes, ``x`` is this data rank's rows of the batch: the dispatch runs on
    the whole batch (the tokens all-gathered in rank order), so capacity
    and aux are pooled over it as in the reference, and each rank keeps its
    own rows."""
    mesh = active_mesh()
    n_dp = data_size(mesh)
    B_loc, S, d = x.shape
    E, k = p["w_gate"].shape[0], cfg.moe_top_k
    dev = x.device
    xt = x.reshape(B_loc * S, d)
    if n_dp > 1:
        xt = gather_rows(xt, mesh)
    N = xt.shape[0]
    w_gate, w_up, w_down = (whole(p[n]) for n in EXPERT_WEIGHTS)
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
    g = einsum("ecd,edf->ecf", buf, w_gate)
    u = einsum("ecd,edf->ecf", buf, w_up)
    h = F.silu(g) * u
    out_e = einsum("ecf,efd->ecd", h, w_down)                  # (E, cap, d)

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

    if n_dp > 1:
        r = data_rank(mesh)
        out = out[r * B_loc * S:(r + 1) * B_loc * S]
    return out.reshape(B_loc, S, d), aux


# ---------------------------------------------------------------------------
# 'local' dispatch: replicated-routing expert parallelism
# ---------------------------------------------------------------------------
def moe_forward_local(cfg: ModelConfig, p, x: torch.Tensor, mesh):
    """x: (B, S, d), this data rank's rows, the same on every model rank ->
    (out, aux).  Each model rank selects the tokens routed to its LOCAL
    experts without a dispatch collective; one sum over ``"model"``
    combines the expert outputs.

    Comm per MoE layer = one (N_loc, d) sum over ``"model"`` (the same wire
    cost as a dense Megatron TP layer) after the all-gather of the local
    experts' d_model shards over the data axes (the FSDP gather; its
    backward pass sums their gradients over the data ranks).

    Backward: the compute after the combine is replicated over the model
    ranks, so the combine passes the gradient on unchanged; the gradient
    that reaches the tokens and the gates through the local experts is
    partial on each model rank and is summed over ``"model"``.  The
    router's aux path is computed whole on every rank and is not summed.
    aux is each data shard's load-balance statistic, averaged over the data
    ranks (the reference returns it from ``shard_map`` replicated while it
    differs between data shards).

    Expert weights: DTensors laid out by ``moe_axes``, or whole tensors
    every rank holds (narrowed to this rank's experts).
    """
    B, S, d = x.shape
    E, k = p["w_gate"].shape[0], cfg.moe_top_k
    n_mp = mesh.size(list(mesh.mesh_dim_names).index("model"))
    if E % n_mp:
        raise ValueError(f"{E} experts do not divide over {n_mp} model ranks")
    E_loc = E // n_mp
    e_lo = mesh.get_local_rank("model") * E_loc
    N_loc = B * S
    cap = max(int(math.ceil(N_loc * k / E * cfg.capacity_factor)), 1)
    dev = x.device
    x_loc = x.reshape(N_loc, d)

    def local_experts(w):
        if isinstance(w, DTensor):
            return whole(w, keep=("model",))
        return w.narrow(0, e_lo, E_loc)

    w_gate, w_up, w_down = (local_experts(p[n]) for n in EXPERT_WEIGHTS)

    probs, gate, eidx = _route(cfg, p, x_loc)                 # (N_loc, .)
    me = probs.mean(dim=0)
    ce = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, eidx.reshape(-1),
        torch.ones(N_loc * k, dtype=torch.float32, device=dev)) / (N_loc * k)
    aux = mean_data(E * torch.sum(me * ce), mesh)

    flat_e = eidx.reshape(-1)                                  # (N_loc*k,)
    flat_g = fan_out_model(gate.reshape(-1), mesh)
    ar = torch.arange(N_loc * k, device=dev)
    tok_of = ar // k
    local_e = flat_e - e_lo                                    # in [0,E_loc)?
    mine = (local_e >= 0) & (local_e < E_loc)
    # rank within local expert via sorted positions
    order = torch.argsort(torch.where(mine, local_e, E_loc), stable=True)
    e_sorted = torch.where(mine, local_e, E_loc)[order]
    start = torch.searchsorted(e_sorted, torch.arange(E_loc, device=dev),
                               side="left")
    rank = ar - start[torch.clamp(e_sorted, 0, E_loc - 1)]
    keep = (e_sorted < E_loc) & (rank < cap)
    slot = torch.where(keep, e_sorted * cap + rank, E_loc * cap)

    x_disp = fan_out_model(x_loc, mesh)
    buf = torch.zeros((E_loc * cap + 1, d), dtype=x.dtype, device=dev)
    buf[slot] = x_disp[tok_of[order]]
    buf = buf[:-1].reshape(E_loc, cap, d)

    g = einsum("ecd,edf->ecf", buf, w_gate)
    u = einsum("ecd,edf->ecf", buf, w_up)
    h = F.silu(g) * u
    out_e = einsum("ecf,efd->ecd", h, w_down).reshape(E_loc * cap, d)

    gathered = torch.where(keep[:, None],
                           out_e[torch.clamp(slot, 0, E_loc * cap - 1)], 0.0)
    contrib = gathered * flat_g[order][:, None].to(x.dtype)
    out = torch.zeros((N_loc, d), dtype=x.dtype, device=dev).index_add_(
        0, tok_of[order], contrib.to(x.dtype))
    out = combine_model(out, mesh).reshape(B, S, d)

    if "shared_gate" in p:
        sg = dot(x_loc, p["shared_gate"])
        su = dot(x_loc, p["shared_up"])
        out = out + dot(F.silu(sg) * su, p["shared_down"]).reshape(B, S, d)
    return out, aux

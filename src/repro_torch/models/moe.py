"""Mixture-of-Experts FFN with sort-based capacity dispatch (port of
``src/repro/models/moe.py``).

Dispatch is static-shaped: the N*k (token, expert) assignments are sorted by
expert id, each assignment gets a rank within its expert, assignments beyond
the per-expert capacity C go to an overflow slot and are dropped, kept
tokens are scattered into an (E, C, d) buffer, the expert GEMMs run as one
batched einsum, and results are combined back with the router gates.

Two dispatches, by ``cfg.moe_impl``:

  * ``"global"`` pools capacity, and the load-balancing aux loss, over the
    whole batch, as the reference's program does on any mesh.  On a mesh
    the dispatch buffer is laid out as the reference constrains it
    (``moe.py:105,112``): experts over "model", capacity rows over the
    data axes.  Each rank routes its own rows, learns from the other data
    ranks' per-expert counts where its assignments fall in the global
    order, and fills the slots of its model rank's experts; one
    reduce-scatter over the data axes gives each rank its capacity rows
    (``scatter_data``), it runs its experts' products on them, one
    all-gather brings the outputs back (``gather_data``), each rank
    combines its tokens' outputs of its experts, and one sum over "model"
    joins the experts;
  * ``"local"`` (``moe_forward_local``, under an active mesh with a
    ``"model"`` axis): each model rank routes its data shard whole, keeps
    only the tokens of its ``E // n_mp`` experts at the per-shard capacity,
    and one sum over ``"model"`` combines the outputs.

The router stays whole (computed on every model rank); the shared experts
(deepseek) are column- and row-parallel over "model" as the dense FFN.
Expert weights arrive gathered over the data axes with their "model" split
kept (``apply_layer``), or as DTensors laid out by ``moe_axes``, which each
path gathers as it needs (``common.whole``).
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
    gather_data,
    gather_rows,
    mean_data,
    model_split,
    randn,
    scatter_data,
    take,
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


def _shared(cfg: ModelConfig, p, xt: torch.Tensor) -> torch.Tensor:
    """The shared experts on tokens ``xt`` (N, d): where their mlp columns
    are split over "model", this rank's columns and rows, summed over the
    model ranks."""
    eff = cfg.moe_d_ff or cfg.d_ff
    sh = model_split(cfg.moe_shared_experts * eff, p["shared_up"], 1)
    x = fan_out_model(xt, sh.mesh) if sh.on else xt
    sg = dot(x, take(sh, p["shared_gate"], 1))
    su = dot(x, take(sh, p["shared_up"], 1))
    out = dot(F.silu(sg) * su, take(sh, p["shared_down"], 0))
    return combine_model(out, sh.mesh) if sh.on else out


def _moe_forward_global(cfg: ModelConfig, p, x: torch.Tensor):
    """x: (B, S, d) -> (out, aux_loss).  Under an active mesh with data
    axes, ``x`` is this data rank's rows of the batch; capacity and aux are
    pooled over the whole batch as in the reference (the module's
    docstring has the layout)."""
    mesh = active_mesh()
    n_dp = data_size(mesh)
    B_loc, S, d = x.shape
    E, k = p["router"].shape[1], cfg.moe_top_k
    dev = x.device
    xt = x.reshape(B_loc * S, d)
    N_loc = xt.shape[0]
    N = N_loc * n_dp
    w_gate, w_up, w_down = (whole(p[n], keep=("model",))
                            for n in EXPERT_WEIGHTS)
    ex = model_split(E, w_gate, 0)
    probs, gate, eidx = _route(cfg, p, xt)

    # load-balancing aux loss (Switch-style) over the whole batch: the
    # router's probabilities gathered in rank order (so its mean is one
    # process's), the experts' counts summed
    me = (gather_rows(probs, mesh) if n_dp > 1 else probs).mean(dim=0)
    counts = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, eidx.reshape(-1),
        torch.ones(N_loc * k, dtype=torch.float32, device=dev))
    if n_dp > 1:
        every = gather_rows(counts[None], mesh)                # (n_dp, E)
        counts = every.sum(0)
        before = every[:data_rank(mesh)].sum(0).long()  # earlier ranks'
    ce = counts / (N * k)
    aux = E * torch.sum(me * ce)

    # --- sort-based dispatch -------------------------------------------------
    NK = N_loc * k
    cap = int(math.ceil(N * k / E * cfg.capacity_factor))
    # the capacity rows split over the data ranks (padded to divide)
    cap_pad = -(-cap // n_dp) * n_dp
    flat_e = eidx.reshape(NK)
    flat_g = gate.reshape(NK)
    ar = torch.arange(NK, device=dev)
    tok_of = ar // k                                           # token index

    order = torch.argsort(flat_e, stable=True)                 # (NK,)
    e_sorted = flat_e[order]
    # rank within expert: position - start offset of that expert's segment
    # (and the earlier data ranks' assignments to it, in the global order)
    start = torch.searchsorted(e_sorted, torch.arange(E, device=dev),
                               side="left")                    # (E,)
    rank = ar - start[e_sorted]
    if n_dp > 1:
        rank = rank + before[e_sorted]
    keep = rank < cap
    if ex.on:  # this model rank's experts only
        keep = keep & (e_sorted >= ex.lo) & (e_sorted < ex.lo + ex.cnt)
    n_slots = ex.cnt * cap_pad
    slot = torch.where(keep, (e_sorted - ex.lo) * cap_pad + rank, n_slots)

    x_disp = fan_out_model(xt, mesh) if ex.on else xt
    buf = torch.zeros((n_slots + 1, d), dtype=x.dtype, device=dev)
    buf[slot] = x_disp[tok_of[order]]
    buf = scatter_data(buf[:-1].reshape(ex.cnt, cap_pad, d), 1, mesh)

    # --- expert FFN (batched over this rank's experts and capacity rows) -----
    g = einsum("ecd,edf->ecf", buf, w_gate)
    u = einsum("ecd,edf->ecf", buf, w_up)
    h = F.silu(g) * u
    out_e = einsum("ecf,efd->ecd", h, w_down)                  # (E, cap, d)

    # --- combine --------------------------------------------------------------
    out_flat = gather_data(out_e, 1, mesh).reshape(n_slots, d)
    gathered = torch.where(keep[:, None],
                           out_flat[torch.clamp(slot, 0, n_slots - 1)], 0.0)
    if ex.on:
        flat_g = fan_out_model(flat_g, mesh)
    contrib = gathered * flat_g[order][:, None].to(x.dtype)
    out = torch.zeros((N_loc, d), dtype=x.dtype, device=dev).index_add_(
        0, tok_of[order], contrib.to(x.dtype))
    if ex.on:
        out = combine_model(out, mesh)

    if "shared_gate" in p:
        out = out + _shared(cfg, p, xt)
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

    Expert weights: DTensors laid out by ``moe_axes``, this rank's experts
    (``apply_layer`` gathers them over the data axes), or whole tensors
    every rank holds (narrowed to this rank's experts).
    """
    B, S, d = x.shape
    E, k = p["router"].shape[1], cfg.moe_top_k
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
        return w.narrow(0, e_lo, E_loc) if w.shape[0] == E else w

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
        out = out + _shared(cfg, p, x_loc).reshape(B, S, d)
    return out, aux

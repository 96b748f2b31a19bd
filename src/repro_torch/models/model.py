"""Decoder-only LM assembled from the mixer/FFN building blocks (port of
``src/repro/models/model.py``).

Layers are grouped into *segments*: maximal runs of a repeating layer
pattern (period <= 8), as in the reference, which stacks each segment's
parameters along a leading axis and runs them with ``lax.scan``.  Here each
segment holds its layers as a ``ModuleList`` per pattern slot and the
forward pass loops over them; caches keep the reference's layout (per
segment, per slot, a leading layer axis), so a cache carries across.

    dense llama-style : one segment  [attn+dense] x L
    deepseek-v3       : [attn+dense] x 3, then [attn(MLA)+moe] x 58
    mamba2            : [ssm] x 48
    jamba             : [(ssm ssm ssm attn ssm ssm ssm ssm) with moe every
                         2nd layer] x 9   (period-8 pattern)

Weights keep the reference's ``(in, out)`` layout (``x @ w``).  Parameters
are built with ``requires_grad=False`` for serving; ``train_step_fn``'s step
switches them on and differentiates ``loss`` with autograd.  In a forward
pass that records gradients, ``cfg.remat`` checkpoints each repetition of a
segment's pattern, as the reference's ``jax.checkpoint`` of its scan body
does: ``"full"`` keeps only its input, ``"dots"`` also keeps the outputs of
its matmuls without batch dimensions (``aten.mm``; the reference's
``checkpoint_dots_with_no_batch_dims``), ``"none"`` keeps everything.  The
three give equal gradients.  ``unroll`` changes nothing here.

On a mesh (``launch.steps.place_model``) the parameters are DTensors laid
out by ``param_axes`` through the sharding rules, and ``train_step_fn``'s
batch is this data rank's rows.  Each layer gathers its weights over the
data axes as it runs, keeping their "model" split (``common.whole``,
inside the remat region, so the backward pass gathers them again), and
computes its share over the model ranks: attention by heads, the dense
FFN and shared experts by mlp columns (column-parallel ``w_gate``/``w_up``,
row-parallel ``w_down``, then one sum over "model"), the SSM by SSD heads,
the MoE by experts; the embedding, the head and the loss by vocab rows.
Under ``cfg.gather_bf16`` a layer's weights are gathered whole and its
compute is replicated over "model", as the reference's flag asks.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (
    ModelConfig,
    active_mesh,
    chunked_cross_entropy,
    combine_model,
    data_size,
    fan_out_model,
    gather_model,
    gelu_mlp,
    lookup,
    mean_data,
    model_split,
    randn,
    rms_norm,
    swiglu,
    take,
    whole,
)


class Params(nn.Module):
    """A tree of parameters addressed like the reference's dicts
    (``p["mixer"]["wq"]``): tensors become parameters, dicts sub-trees."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, Params(v))
            else:
                self.register_parameter(k, nn.Parameter(v,
                                                        requires_grad=False))

    def __getitem__(self, k):
        return getattr(self, k)

    def __contains__(self, k) -> bool:
        return k in self._parameters or k in self._modules

    def whole(self, keep: tuple[str, ...] = ()) -> dict:
        """The tree as dicts of tensors, each DTensor gathered over every
        mesh dim but those named in ``keep`` (``common.whole``)."""
        out = {k: whole(v, keep) for k, v in self._parameters.items()}
        out.update((k, m.whole(keep)) for k, m in self._modules.items())
        return out


# ---------------------------------------------------------------------------
# segments
# ---------------------------------------------------------------------------
def layer_specs(cfg: ModelConfig) -> list[tuple[str, str]]:
    return [(cfg.layer_kind(i), cfg.ffn_kind(i)) for i in range(cfg.n_layers)]


def build_segments(cfg: ModelConfig) -> list[tuple[tuple[tuple[str, str], ...], int]]:
    kinds = layer_specs(cfg)
    L = len(kinds)
    segments = []
    i = 0
    while i < L:
        best_p, best_r = 1, 1
        for p in (1, 2, 4, 8):
            if i + p > L:
                break
            pat = kinds[i:i + p]
            r = 1
            while i + p * (r + 1) <= L and kinds[i + p * r:i + p * (r + 1)] == pat:
                r += 1
            if p > 1 and r < 2:
                continue  # an unrepeated multi-layer pattern
            if p * r > best_p * best_r:
                best_p, best_r = p, r
        segments.append((tuple(kinds[i:i + best_p]), best_r))
        i += best_p * best_r
    return segments


# ---------------------------------------------------------------------------
# per-layer params / apply
# ---------------------------------------------------------------------------
def _dense_ffn_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    pd = cfg.param_dtype
    if cfg.act == "swiglu":
        return {
            "w_gate": randn(gen, (d, ff), s_in, pd),
            "w_up": randn(gen, (d, ff), s_in, pd),
            "w_down": randn(gen, (ff, d), s_out, pd),
        }
    return {
        "w_up": randn(gen, (d, ff), s_in, pd),
        "w_down": randn(gen, (ff, d), s_out, pd),
    }


def _dense_ffn_axes(cfg: ModelConfig) -> dict:
    if cfg.act == "swiglu":
        return {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
                "w_down": ("mlp", "embed")}
    return {"w_up": ("embed", "mlp"), "w_down": ("mlp", "embed")}


def layer_params(cfg: ModelConfig, spec: tuple[str, str],
                 gen: torch.Generator) -> dict:
    mixer, ffn = spec
    ones = dict(dtype=cfg.param_dtype, device=gen.device)
    p: dict = {"norm1": torch.ones((cfg.d_model,), **ones)}
    if mixer == "attn":
        p["mixer"] = (attn_mod.mla_params(cfg, gen) if cfg.mla
                      else attn_mod.gqa_params(cfg, gen))
    else:
        p["mixer"] = ssm_mod.ssm_params(cfg, gen)
    if ffn != "none":
        p["norm2"] = torch.ones((cfg.d_model,), **ones)
        p["ffn"] = (moe_mod.moe_params(cfg, gen) if ffn == "moe"
                    else _dense_ffn_params(cfg, gen))
    return p


def layer_axes(cfg: ModelConfig, spec: tuple[str, str]) -> dict:
    mixer, ffn = spec
    ax: dict = {"norm1": ("act_embed",)}
    if mixer == "attn":
        ax["mixer"] = attn_mod.mla_axes() if cfg.mla else attn_mod.gqa_axes()
    else:
        ax["mixer"] = ssm_mod.ssm_axes()
    if ffn != "none":
        ax["norm2"] = ("act_embed",)
        ax["ffn"] = (moe_mod.moe_axes(cfg) if ffn == "moe"
                     else _dense_ffn_axes(cfg))
    return ax


def dense_ffn(cfg: ModelConfig, f, x: torch.Tensor) -> torch.Tensor:
    """The dense FFN; where its mlp columns are split over "model", this
    rank's column-parallel ``w_gate``/``w_up`` and row-parallel ``w_down``
    give a partial output, summed over the model ranks."""
    ff = model_split(cfg.d_ff, f["w_up"], 1)
    x = fan_out_model(x, ff.mesh) if ff.on else x
    up, down = take(ff, f["w_up"], 1), take(ff, f["w_down"], 0)
    if cfg.act == "swiglu":
        out = swiglu(x, take(ff, f["w_gate"], 1), up, down)
    else:
        out = gelu_mlp(x, up, down)
    return combine_model(out, ff.mesh) if ff.on else out


def apply_layer(cfg: ModelConfig, spec: tuple[str, str], p, x: torch.Tensor,
                positions: torch.Tensor, cache: dict | None, cache_len):
    """Returns (x, new_cache_dict_or_None, aux_loss).  A layer on a mesh
    gathers its weights over the data axes first, keeping their "model"
    split (whole under ``cfg.gather_bf16``)."""
    mixer, ffn = spec
    if isinstance(p, Params) and isinstance(p["norm1"], DTensor):
        p = p.whole(() if cfg.gather_bf16 else ("model",))
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    new_cache = None
    if mixer == "attn":
        kv = None
        if cache is not None:
            kv = attn_mod.KVCache(k=cache["k"], v=cache["v"], length=cache_len)
        fwd = attn_mod.mla_forward if cfg.mla else attn_mod.gqa_forward
        out, kv2 = fwd(cfg, p["mixer"], h, positions, kv)
        if kv2 is not None:
            new_cache = {"k": kv2.k, "v": kv2.v}
        elif cache is not None:
            new_cache = {"k": cache["k"], "v": cache["v"]}
    else:
        sc = None
        if cache is not None:
            sc = ssm_mod.SSMCache(conv=cache["conv"], state=cache["state"],
                                  length=cache_len)
        out, sc2 = ssm_mod.ssm_forward(cfg, p["mixer"], h, sc)
        if sc2 is not None:
            new_cache = {"conv": sc2.conv, "state": sc2.state}
        elif cache is not None:
            new_cache = {"conv": cache["conv"], "state": cache["state"]}
    x = x + out.to(x.dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn != "none":
        h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
        f = p["ffn"]
        if ffn == "moe":
            out2, aux = moe_mod.moe_forward(cfg, f, h2)
        else:
            out2 = dense_ffn(cfg, f, h2)
        x = x + out2.to(x.dtype)
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------
def layer_cache_init(cfg: ModelConfig, spec: tuple[str, str], batch: int,
                     max_len: int, dtype, device=None) -> dict:
    mixer, _ = spec
    if mixer == "attn":
        kv = (attn_mod.mla_cache_init if cfg.mla else
              attn_mod.gqa_cache_init)(cfg, batch, max_len, dtype, device)
        return {"k": kv.k, "v": kv.v}
    sc = ssm_mod.ssm_cache_init(cfg, batch, dtype, device)
    return {"conv": sc.conv, "state": sc.state}


def cache_axes(cfg: ModelConfig, spec: tuple[str, str], *,
               seq_axis: str = "seq_kv") -> dict:
    """Logical axes for one layer's cache (stacking axis added by caller)."""
    mixer, _ = spec
    if mixer == "attn":
        if cfg.mla:
            return {"k": ("batch", seq_axis, None),
                    "v": ("batch", seq_axis, None)}
        return {"k": ("batch", seq_axis, "kv_heads", None),
                "v": ("batch", seq_axis, "kv_heads", None)}
    return {"conv": ("batch", None, "ssm_inner"),
            "state": ("batch", "ssm_inner", None, None)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> list:
    """Per segment, per slot, each cache array with a leading layer axis."""
    dev = resolve_device(device)
    caches = []
    for pattern, r in build_segments(cfg):
        seg = {}
        for si, spec in enumerate(pattern):
            one = layer_cache_init(cfg, spec, batch, max_len, dtype, dev)
            seg[f"slot{si}"] = {k: a[None].expand((r,) + a.shape).clone()
                                for k, a in one.items()}
        caches.append(seg)
    return caches


# ---------------------------------------------------------------------------
# activation checkpointing (cfg.remat)
# ---------------------------------------------------------------------------
def _save_dots(ctx, op, *args, **kwargs):
    """Keep the outputs of matmuls without batch dimensions, recompute the
    rest."""
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


#: ``torch.utils.checkpoint`` arguments per ``cfg.remat``; another value
#: checkpoints nothing, as in the reference
_REMAT = {
    "full": {},
    "dots": {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _save_dots)},
}


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------
def _stacked(tree):
    """Each tuple leaf with the leading layer axis (None) of a stack."""
    if isinstance(tree, dict):
        return {k: _stacked(v) for k, v in tree.items()}
    return (None,) + tuple(tree)


def param_axes(cfg: ModelConfig) -> dict:
    """The logical axes of the reference's parameter tree (segment leaves
    stacked along a leading layer axis, None); nothing is built."""
    axes: dict = {
        "embed": ("vocab", "embed"),
        "head": ("embed", "vocab"),
        "final_norm": ("act_embed",),
        "segments": [],
    }
    for pattern, _ in build_segments(cfg):
        axes["segments"].append({
            f"slot{slot}": _stacked(layer_axes(cfg, spec))
            for slot, spec in enumerate(pattern)})
    if cfg.mtp_depth:
        axes["mtp"] = {
            "proj": ("embed", None),
            "norm_h": ("act_embed",), "norm_e": ("act_embed",),
            "block": layer_axes(cfg, ("attn", "dense")),
        }
    return axes


class LanguageModel(nn.Module):
    """The LM: its parameters (made from ``generator``, on ``device``) and
    the segment plan.  ``layers[si][f"slot{j}"][li]`` is layer ``li`` of
    segment ``si``'s pattern slot ``j`` (the reference's
    ``params["segments"][si][f"slot{j}"]`` at index ``li``)."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else \
            torch.Generator(device=dev).manual_seed(0)
        if gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, model on {dev}")
        self.cfg = cfg
        self.segments = build_segments(cfg)
        pd = cfg.param_dtype
        self.embed = nn.Parameter(randn(gen, (cfg.vocab, cfg.d_model), 0.02,
                                        pd), requires_grad=False)
        self.head = nn.Parameter(randn(gen, (cfg.d_model, cfg.vocab),
                                       1.0 / math.sqrt(cfg.d_model), pd),
                                 requires_grad=False)
        self.final_norm = nn.Parameter(
            torch.ones((cfg.d_model,), dtype=pd, device=dev),
            requires_grad=False)
        self.layers = nn.ModuleList(
            nn.ModuleDict({
                f"slot{slot}": nn.ModuleList(
                    Params(layer_params(cfg, spec, gen)) for _ in range(r))
                for slot, spec in enumerate(pattern)})
            for pattern, r in self.segments)
        if cfg.mtp_depth:
            d = cfg.d_model
            self.mtp = Params({
                "proj": randn(gen, (2 * d, d), 1.0 / math.sqrt(2 * d), pd),
                "norm_h": torch.ones((d,), dtype=pd, device=dev),
                "norm_e": torch.ones((d,), dtype=pd, device=dev),
                "block": layer_params(cfg, ("attn", "dense"), gen),
            })

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def param_groups(self) -> list[dict]:
        """The parameters as ``optim.AdamW`` groups: the layers of the
        segments (the reference stacks each along a leading layer axis, so
        its decay rule counts one more axis for them) and the rest."""
        stacked = list(self.layers.parameters())
        ids = {id(p) for p in stacked}
        return [{"params": [p for p in self.parameters() if id(p) not in ids]},
                {"params": stacked, "stacked": True}]

    def param_axes(self) -> dict:
        """The reference's ``param_axes`` tree (``param_axes(cfg)``); a
        segment leaf's axes without their leading None are those of each
        of its layers' tensors."""
        return param_axes(self.cfg)

    # ---- forward ----
    def forward(self, tokens: torch.Tensor, *, frontend=None, caches=None,
                cache_len=None, positions=None):
        """tokens (B, S) -> (h (B, S, d), aux, new caches or None)."""
        cfg = self.cfg
        B, S = tokens.shape
        x = self._embed(tokens).to(cfg.compute_dtype)
        if frontend is not None:
            F_ = frontend.shape[1]
            x = torch.cat([frontend.to(x.dtype), x[:, F_:]], dim=1)
        if positions is None:
            base = cache_len if cache_len is not None else 0
            positions = base + torch.arange(S, dtype=torch.int32,
                                            device=x.device)[None, :]
            positions = positions.expand(B, S)
        clen = cache_len if cache_len is not None else 0

        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        new_caches = [] if caches is not None else None
        training = caches is None and torch.is_grad_enabled()
        remat = _REMAT.get(cfg.remat) if training else None
        for si, (pattern, r) in enumerate(self.segments):
            seg = self.layers[si]
            seg_c = caches[si] if caches is not None else None
            outs = {f"slot{j}": [] for j in range(len(pattern))}
            for li in range(r):
                def body(x, aux, pattern=pattern, seg=seg, seg_c=seg_c,
                         li=li):
                    """One repetition of the pattern (the reference's scan
                    body) -> (x, aux, {slot: new cache})."""
                    ncs = {}
                    for slot, spec in enumerate(pattern):
                        name = f"slot{slot}"
                        c = None if seg_c is None else \
                            {k: a[li] for k, a in seg_c[name].items()}
                        x, ncs[name], a = apply_layer(
                            cfg, spec, seg[name][li], x, positions, c, clen)
                        aux = aux + a
                    return x, aux, ncs

                if remat is None:
                    x, aux_total, ncs = body(x, aux_total)
                    for name, nc in ncs.items():
                        outs[name].append(nc)
                else:
                    x, aux_total, _ = checkpoint(body, x, aux_total,
                                                 use_reentrant=False, **remat)
            if seg_c is not None:
                new_caches.append({
                    name: {k: torch.stack([c[k] for c in cs])
                           for k in cs[0]}
                    for name, cs in outs.items()})
        h = rms_norm(x, whole(self.final_norm), cfg.norm_eps)
        return h, aux_total, new_caches

    def _embed(self, tokens):
        """The embedding rows of ``tokens``, vocab-parallel where the
        embedding's vocab is split over "model" (``common.lookup``)."""
        table = whole(self.embed, keep=("model",))
        return lookup(table, tokens, model_split(self.cfg.vocab, table, 0))

    def _head(self, dtype):
        """(this rank's head columns in ``dtype``, their vocab split)."""
        head = whole(self.head, keep=("model",))
        return head.to(dtype), model_split(self.cfg.vocab, head, 1)

    def _logits(self, h):
        """The last position's logits (B, V), gathered over the model
        ranks where the vocab is split."""
        head, vs = self._head(h.dtype)
        return gather_model(h[:, -1] @ head, 1, vs)

    # ---- losses / steps ----
    def loss(self, tokens, labels, frontend=None):
        """(total, {"ce", "aux"}): the training loss, differentiable."""
        cfg = self.cfg
        h, aux, _ = self.forward(tokens, frontend=frontend)
        head, vs = self._head(cfg.compute_dtype)
        ce = chunked_cross_entropy(h, head, labels, unroll=cfg.unroll,
                                   vocab=vs)
        total = ce + 0.01 * aux
        if cfg.mtp_depth:
            total = total + 0.3 * self._mtp_loss(h, tokens, labels)
        return total, {"ce": ce, "aux": aux}

    def _mtp_loss(self, h, tokens, labels):
        """deepseek-style multi-token prediction (depth 1): predict t+2 from
        the main trunk's hidden state at t combined with the embedding of
        t+1."""
        cfg = self.cfg
        mtp = self.mtp
        B, S = tokens.shape
        e_next = self._embed(tokens[:, 1:]).to(h.dtype)
        hh = rms_norm(h[:, :-1], whole(mtp["norm_h"]), cfg.norm_eps)
        ee = rms_norm(e_next, whole(mtp["norm_e"]), cfg.norm_eps)
        z = torch.cat([hh, ee], dim=-1) @ whole(mtp["proj"]).to(h.dtype)
        positions = torch.arange(S - 1, dtype=torch.int32,
                                 device=h.device)[None].expand(B, S - 1)
        z, _, _ = apply_layer(cfg, ("attn", "dense"), mtp["block"], z,
                              positions, None, 0)
        head, vs = self._head(h.dtype)
        return chunked_cross_entropy(z, head, labels[:, 1:],
                                     unroll=cfg.unroll, vocab=vs)

    @torch.no_grad()
    def prefill(self, tokens, caches, frontend=None):
        """Prompt tokens (B, S) into empty caches -> (last logits (B, V),
        caches holding S positions)."""
        h, _, new_caches = self.forward(tokens, frontend=frontend,
                                        caches=caches, cache_len=0)
        return self._logits(h), new_caches

    @torch.no_grad()
    def decode_step(self, token, caches, cache_len):
        """token: (B, 1) at position ``cache_len`` -> (logits (B, V), new
        caches)."""
        h, _, new_caches = self.forward(token, caches=caches,
                                        cache_len=cache_len)
        return self._logits(h), new_caches


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> LanguageModel:
    """A ``LanguageModel`` whose weights are drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    return LanguageModel(cfg, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(seed))


# step functions: the reference's take the parameter tree first; the port's
# take the LanguageModel, which holds the parameters
def train_step_fn(cfg: ModelConfig, optimizer: torch.optim.Optimizer):
    """``step(model, batch) -> {"loss", "ce", "aux"}``: zero the gradients,
    differentiate ``model.loss`` (its parameters switched to
    ``requires_grad``), and step ``optimizer``, which updates the model's
    parameters in place.

    Under an active mesh the batch is this data rank's rows: each rank
    differentiates its loss over the number of data ranks (the weights'
    gathers sum the gradients over them), and the metrics returned are the
    means over the data ranks, the whole batch's."""
    def step(model: LanguageModel, batch: dict) -> dict:
        if model.cfg != cfg:
            raise ValueError("the model was built for another config")
        mesh = active_mesh()
        n_dp = data_size(mesh)
        model.requires_grad_(True)
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = model.loss(batch["tokens"], batch["labels"],
                                   frontend=batch.get("frontend"))
        (loss / n_dp if n_dp > 1 else loss).backward()
        optimizer.step()
        out = {"loss": loss.detach(), "ce": metrics["ce"].detach(),
               "aux": metrics["aux"].detach()}
        if n_dp > 1:
            out = {k: mean_data(v, mesh) for k, v in out.items()}
        return out

    return step


def prefill_step_fn(cfg: ModelConfig):
    def step(model: LanguageModel, batch: dict, caches):
        if model.cfg != cfg:
            raise ValueError("the model was built for another config")
        return model.prefill(batch["tokens"], caches,
                             frontend=batch.get("frontend"))

    return step


def decode_step_fn(cfg: ModelConfig):
    def step(model: LanguageModel, token, caches, cache_len):
        if model.cfg != cfg:
            raise ValueError("the model was built for another config")
        return model.decode_step(token, caches, cache_len)

    return step


"""Cells (port of ``src/repro/launch/steps.py``): (architecture x
input shape x mesh) -> a step function, the ``(shape, dtype)`` specs of its
inputs, their placements on the mesh, and what it updates in place; and
the parameters put on a mesh by their logical axes (``place_model``).

The same functions serve the dry run and the real training and serving
steps, so what is dry run is what runs.  In the reference the dry run lowers and compiles the
step under ``jax.jit``.  The port has no compiler; its counterpart of
"lower and compile" is one run of the same step on fake tensors
(``lower_cell``):

  * under ``FakeTensorMode``: nothing is allocated and no kernel runs;
  * over a ``torch.distributed`` group of backend ``"fake"`` of the mesh's
    size (256 or 512 ranks for the production meshes; the caller makes it,
    as ``launch.dryrun`` does), the parameters, the optimizer state and
    the inputs laid out on it as DTensors, this rank holding its shards;
  * inside ``hlo_analysis.TraceRecorder``, whose record (every aten op with
    its shapes, every collective with its group size, where each came
    from, the live bytes of every storage) stands in for the optimized
    HLO.

The fake tensors lie on the card (``cuda``) where PyTorch has one, else on
the CPU (``trace_device``): a CPU-only build cannot run autograd on fake
CUDA tensors (its engine needs the CUDA device guard and aborts without
it).  The model has no device-dependent path, so the record is the same
aten program on either.  The same ``Cell`` run on real tensors
(``cell.make_args`` outside a fake mode, then ``cell.step``) is the real
step: one construction, two executions.

A step computes as the port's mesh path does (``models.common``): a
batch split over the data axes (the "batch" rule's; ``long_500k`` splits
none), each layer's weights gathered over the data axes with their
"model" split kept, and each model rank computing its share of the heads,
mlp columns, experts, vocab rows and SSD heads, as GSPMD splits the
reference's program.  A prefill or decode step runs on the cache as it is
laid out, this rank's block: its data rank's rows, its share of the
positions where the rules split them (``decode_32k`` puts them on
"model", ``long_500k`` on every dim), its SSD heads.  Only the SSM's conv
window, its last ``K - 1`` pre-conv inputs, is gathered whole (over the
dims that split its channels), and each rank keeps its slice of the new
one.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.configs import SHAPES, get_config, get_smoke_config, input_specs
from repro_torch.device import resolve_device
from repro_torch.launch.hlo_analysis import Trace, TraceRecorder
from repro_torch.models.common import (
    ModelConfig,
    _resolve,
    axes_size,
    data_axes,
    position_axes,
    set_active_mesh,
    set_mesh_rules,
    spec_placements,
    whole,
)
from repro_torch.models.convert import _entries
from repro_torch.models.model import (
    build_segments,
    cache_axes,
    init_cache,
    init_params,
    train_step_fn,
)
from repro_torch.optim import AdamW

# per-shape sharding-rule overrides (the reference's)
SHAPE_RULES = {
    "train_4k": {},
    "prefill_32k": {},
    "decode_32k": {"seq_kv": "model"},
    "long_500k": {"batch": None, "seq_kv": ("pod", "data", "model")},
}


def _spec(mesh, shape, axes) -> tuple:
    """The reference's spec for a leaf: each dim's resolved mesh axes,
    dropped to replicated where the dim does not divide over them."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    spec = list(_resolve(axes, mesh))
    spec += [None] * (len(shape) - len(spec))
    fixed = []
    for dim, sp in zip(shape, spec):
        if sp is None:
            fixed.append(None)
            continue
        total = 1
        for ax in (sp if isinstance(sp, tuple) else (sp,)):
            total *= sizes.get(ax, 1)
        fixed.append(sp if dim % total == 0 else None)
    return tuple(fixed)


def shardings_from_axes(mesh, shapes_tree, axes_tree):
    """Map a logical-axes tree (tuple leaves) onto DTensor placements, one
    tuple per leaf of ``shapes_tree`` (leaves need a ``shape``; dicts and
    lists as in the reference's trees).

    Placements must divide exactly, so any dim not divisible by its
    assigned mesh axes is dropped to replicated (e.g. mamba2's vocab 50280
    over 16)."""
    def build(shapes, axes):
        if isinstance(shapes, dict):
            return {k: build(shapes[k], axes[k]) for k in shapes}
        if isinstance(shapes, (list, tuple)):
            return type(shapes)(build(s, a) for s, a in zip(shapes, axes))
        return spec_placements(_spec(mesh, tuple(shapes.shape), tuple(axes)),
                               mesh)
    return build(shapes_tree, axes_tree)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def model_placements(model, mesh) -> list:
    """(parameter, placements) for each of ``model``'s tensors: its leaf of
    ``shardings_from_axes`` over the reference's stacked tree, less the
    stacked leaves' leading layer axis (never sharded)."""
    axes = model.param_axes()
    out = []
    for path, ps, stacked in _entries(model):
        shape = ((len(ps),) if stacked else ()) + tuple(ps[0].shape)
        pl = spec_placements(_spec(mesh, shape, _at(axes, path)), mesh)
        if stacked:
            pl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
                       for p in pl)
        out.extend((p, pl) for p in ps)
    return out


def place_model(model, mesh) -> None:
    """Put ``model``'s parameters on ``mesh`` as DTensors with the plan's
    placements, each rank keeping its shard of the tensor it holds (every
    rank built the same weights from the same seed).  Build an optimizer
    after this: its moments follow the parameters' layout."""
    placed = {id(p): pl for p, pl in model_placements(model, mesh)}
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        dt = distribute_tensor(p.detach(), mesh, placed[id(p)],
                               src_data_rank=None)
        mod.register_parameter(leaf, nn.Parameter(
            dt, requires_grad=p.requires_grad))


# ---------------------------------------------------------------------------
# axis trees of a cell's inputs
# ---------------------------------------------------------------------------
def batch_axes(cfg: ModelConfig, shape: str) -> dict:
    spec = SHAPES[shape]
    if spec.kind == "train":
        ax = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
        if cfg.frontend_tokens:
            ax["frontend"] = ("batch", None, "act_embed")
        return ax
    if spec.kind == "prefill":
        ax = {"tokens": ("batch", "seq")}
        if cfg.frontend_tokens:
            ax["frontend"] = ("batch", None, "act_embed")
        return ax
    return {"tokens": ("batch", None), "cache_len": ()}


def cache_axes_tree(cfg: ModelConfig) -> list:
    """Axes tree mirroring init_cache structure (leading stack axis -> None)."""
    out = []
    for pattern, _r in build_segments(cfg):
        seg = {}
        for si, spec in enumerate(pattern):
            one = cache_axes(cfg, spec)
            seg[f"slot{si}"] = {k: (None,) + tuple(ax) for k, ax in one.items()}
        out.append(seg)
    return out


def pick_optimizer(cfg: ModelConfig, params) -> AdamW:
    """AdamW over ``params`` (``model.param_groups()``)."""
    # int8 second moment for >15B-param models: the difference between
    # fitting and not fitting optimizer state in HBM at this mesh size.
    big = cfg.n_params() > 15e9
    return AdamW(params, lr=3e-4, quantize_v=big)


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------
@dataclass
class Cell:
    """A step and what it runs on.  ``step(*make_args(device))``: the
    train step ``(model, optimizer, batch) -> metrics``, the prefill step
    ``(model, batch, caches) -> (logits, caches)`` or the decode step
    ``(model, token, caches, cache_len) -> (logits, caches)``.  ``args``
    holds the ``(shape, dtype)`` specs of the step's inputs after the model
    (and optimizer), as global shapes in the reference's trees, and
    ``in_shardings`` their placements; the model's parameters and the
    optimizer's state are laid out by ``place_model`` (``param_axes``
    through the rules, as ``shardings_from_axes`` maps them).  The train
    step updates the parameters in place and the optimizer's state (the
    reference donates both); a prefill or decode step returns a new cache
    (the reference donates the old one)."""
    arch: str
    shape: str
    cfg: ModelConfig
    step: Any
    args: tuple
    in_shardings: tuple
    donate_argnums: tuple
    kind: str
    rules: dict | None = None
    make_args: Callable | None = None


def trace_device() -> str:
    """The device of a dry run's fake tensors: the card where PyTorch has
    one, else the CPU (see the module's docstring)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _map(fn, *trees):
    """``fn`` over the leaves of parallel dict/list trees."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, list):
        return [_map(fn, *x) for x in zip(*trees)]
    return fn(*trees)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def layout(mesh, tensors, placements):
    """Global tensors -> DTensors with this rank's pieces (a tree), or the
    tensors as they are without a mesh."""
    if mesh is None:
        return tensors
    return _map(lambda t, pl: distribute_tensor(t, mesh, pl,
                                                src_data_rank=None),
                tensors, placements)


def _kept(t, bdim: int) -> tuple:
    """The data axes that split ``t``'s batch dim ``bdim``."""
    dp = data_axes(t.device_mesh)
    return tuple(a for a, p in zip(t.device_mesh.mesh_dim_names, t.placements)
                 if a in dp and p == Shard(bdim))


def _local(t, bdim: int = 0):
    """A DTensor input as this rank computes on it: gathered over every
    mesh dim but the data axes that split its batch dim ``bdim`` (this
    data rank's rows kept)."""
    if not isinstance(t, DTensor):
        return t
    if t.device_mesh.size() == 1:
        return t.to_local()
    return whole(t, keep=_kept(t, bdim))


def _cache_in(name: str, t):
    """A cache leaf (layers, batch, ...) as the model computes on it: this
    rank's block as laid out, but the SSM's conv window, gathered over the
    dims that split its channels."""
    if not isinstance(t, DTensor):
        return t
    return _local(t, 1) if name == "conv" else t.to_local()


def _cache_out(name: str, x, like):
    """A new cache leaf laid out as the old one ``like`` (no collective: a
    conv window keeps this rank's slice of the whole)."""
    if not isinstance(like, DTensor):
        return x
    mesh = like.device_mesh
    if name != "conv":
        return DTensor.from_local(x, mesh, like.placements, run_check=False,
                                  shape=like.shape, stride=like.stride())
    keep = _kept(like, 1)
    gathered = [p if a in keep else Replicate()
                for a, p in zip(mesh.mesh_dim_names, like.placements)]
    return DTensor.from_local(x, mesh, gathered, run_check=False
                              ).redistribute(mesh, like.placements)


def _cache_map(fn, *trees):
    """``fn(name, *leaves)`` over parallel cache trees (per segment, per
    slot, each leaf by name)."""
    return [{slot: {k: fn(k, *(t[si][slot][k] for t in trees))
                    for k in seg[slot]} for slot in seg}
            for si, seg in enumerate(trees[0])]


def _check_positions(cfg: ModelConfig, mesh, cache_specs, cache_sh) -> None:
    """Raise unless every attention cache's positions are split as the
    rules ask (the model reads the split from the rules): a cache whose
    positions do not divide over those ranks is left whole by the plan."""
    pos = position_axes(mesh)
    if not pos:
        return
    names = list(mesh.mesh_dim_names)
    for si, seg in enumerate(cache_sh):
        for slot, leaves in seg.items():
            for k in ("k", "v"):
                if k in leaves and any(leaves[k][names.index(a)] != Shard(2)
                                       for a in pos):
                    T = cache_specs[si][slot][k][0][2]
                    raise ValueError(
                        f"{cfg.name}: a cache of {T} positions does not "
                        f"divide over the {axes_size(mesh, pos)} ranks of "
                        f"{pos}")


def _inputs(cfg: ModelConfig, ins: dict, gen, dev) -> dict:
    """Random global tensors for ``input_specs``' specs: tokens and labels
    in the vocab, a frontend's embeddings normal."""
    out = {}
    for k, (shape, dtype) in ins.items():
        if dtype.is_floating_point:
            out[k] = torch.randn(shape, generator=gen, device=dev).to(dtype)
        else:
            out[k] = torch.randint(0, cfg.vocab, shape, generator=gen,
                                   device=dev, dtype=dtype)
    return out


def build_cell(arch: str, shape: str, mesh, *, smoke: bool = False,
               rules: dict | None = None, unroll: bool = True,
               overrides: dict | None = None) -> Cell:
    """The cell of ``arch`` x ``shape`` on ``mesh`` (a ``DeviceMesh`` over
    the caller's process group, or None for one device).  The rules are
    set and the mesh made active, as the reference's ``build_cell`` does;
    ``unroll`` and ``overrides`` replace fields of the config.  The train
    step's gradients are DTensors laid out as their parameters (each
    weight's gather sums its gradient over the data axes into this rank's
    shard): the counterpart of the reference's constraint on them."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if unroll:
        cfg = dataclasses.replace(cfg, unroll=True)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    spec = SHAPES[shape]
    if rules is None:
        rules = dict(SHAPE_RULES.get(shape, {}))
    set_mesh_rules(rules)
    set_active_mesh(mesh)

    def place(specs, axes):
        if mesh is None:
            return _map(lambda s, a: None, specs, axes)
        return shardings_from_axes(mesh, _map(_Spec, specs), axes)

    ins = input_specs(cfg, shape)
    batch_sh = place(ins, batch_axes(cfg, shape))
    cache_specs = None
    if spec.kind != "train":
        cache_specs = _cache_specs(cfg, spec.batch, spec.seq)
        cache_sh = place(cache_specs, cache_axes_tree(cfg))
        if mesh is not None:
            _check_positions(cfg, mesh, cache_specs, cache_sh)

    def model_on(dev, seed):
        model = init_params(cfg, seed, device=dev)
        if mesh is not None:
            place_model(model, mesh)
        return model

    if spec.kind == "train":
        def step(model, optimizer, batch):
            local = {k: _local(v) for k, v in batch.items()}
            return train_step_fn(cfg, optimizer)(model, local)

        def make_args(device=None, *, seed: int = 0, batch=None):
            """(model, optimizer with its state made, batch): ``batch``
            global tensors (default random from ``seed``)."""
            dev = resolve_device(device)
            model = model_on(dev, seed)
            opt = pick_optimizer(cfg, model.param_groups())
            for p in model.parameters():
                opt.moments(p)
            if batch is None:
                gen = torch.Generator(device=dev).manual_seed(seed + 1)
                batch = _inputs(cfg, ins, gen, dev)
            return model, opt, layout(mesh, batch, batch_sh)

        return Cell(arch, shape, cfg, step, (ins,), (batch_sh,),
                    donate_argnums=(0, 1), kind="train", rules=rules,
                    make_args=make_args)

    def run(model, fn, caches):
        logits, new = fn(_cache_map(_cache_in, caches))
        return logits, _cache_map(_cache_out, new, caches)

    if spec.kind == "prefill":
        def step(model, batch, caches):
            local = {k: _local(v) for k, v in batch.items()}
            return run(model, lambda c: model.prefill(
                local["tokens"], c, frontend=local.get("frontend")), caches)

        def make_args(device=None, *, seed: int = 0, batch=None):
            """(model, batch, empty caches of ``spec.seq`` positions)."""
            dev = resolve_device(device)
            model = model_on(dev, seed)
            if batch is None:
                gen = torch.Generator(device=dev).manual_seed(seed + 1)
                batch = _inputs(cfg, ins, gen, dev)
            caches = init_cache(cfg, spec.batch, spec.seq, cfg.compute_dtype,
                                dev)
            return (model, layout(mesh, batch, batch_sh),
                    layout(mesh, caches, cache_sh))

        return Cell(arch, shape, cfg, step, (ins, cache_specs),
                    (batch_sh, cache_sh), donate_argnums=(2,),
                    kind="prefill", rules=rules, make_args=make_args)

    # decode: one new token against a cache of spec.seq positions
    tok_specs = {"tokens": ins["tokens"]}

    def step(model, token, caches, cache_len):
        tok = _local(token["tokens"])
        clen = _local(cache_len)
        return run(model, lambda c: model.decode_step(tok, c, clen), caches)

    def make_args(device=None, *, seed: int = 0, batch=None):
        """(model, token, caches of ``spec.seq`` positions, cache length
        ``spec.seq - 1``: the last position is written)."""
        dev = resolve_device(device)
        model = model_on(dev, seed)
        if batch is None:
            gen = torch.Generator(device=dev).manual_seed(seed + 1)
            batch = _inputs(cfg, tok_specs, gen, dev)
        caches = init_cache(cfg, spec.batch, spec.seq, cfg.compute_dtype, dev)
        clen = torch.tensor(spec.seq - 1, dtype=torch.int32, device=dev)
        return (model, layout(mesh, batch, batch_sh_tok),
                layout(mesh, caches, cache_sh),
                layout(mesh, clen, clen_sh))

    batch_sh_tok = {"tokens": batch_sh["tokens"]}
    clen_sh = batch_sh["cache_len"]
    return Cell(arch, shape, cfg, step, (tok_specs, cache_specs, ins["cache_len"]),
                (batch_sh_tok, cache_sh, clen_sh), donate_argnums=(2,),
                kind="decode", rules=rules, make_args=make_args)


class _Spec:
    """A ``(shape, dtype)`` spec with the ``shape`` that
    ``shardings_from_axes`` reads."""

    def __init__(self, spec):
        self.shape, self.dtype = spec


def _cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> list:
    """``(shape, dtype)`` of ``init_cache``'s leaves, nothing allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        caches = init_cache(cfg, batch, max_len, cfg.compute_dtype, "cpu")
    return _map(lambda t: (tuple(t.shape), t.dtype), caches)


def _state_tensors(args) -> list:
    """The local tensors of a step's arguments or results: a model's
    parameters, an optimizer's state, and the tensors of dict/list/tuple
    trees, each DTensor as this rank's shard."""
    out = []
    for a in (args if isinstance(args, tuple) else (args,)):
        if isinstance(a, nn.Module):
            out.extend(a.parameters())
        elif isinstance(a, torch.optim.Optimizer):
            out.extend(t for st in a.state.values()
                       for t in (st.values() if isinstance(st, dict) else [st])
                       if isinstance(t, torch.Tensor))
        else:
            out.extend(t for t in _leaves(a) if isinstance(t, torch.Tensor))
    return [t.to_local() if isinstance(t, DTensor) else t for t in out]


def lower_cell(cell: Cell, mesh, *, device: str | None = None) -> Trace:
    """The cell's step run once on fake tensors of ``device`` (default
    ``trace_device()``) under a ``TraceRecorder``: its ``Trace``, with the
    memory of one device (arguments, outputs, in-place updates as alias,
    peak).  The mesh is over the caller's process group (a fake one of the
    mesh's size for a dry run)."""
    import time

    from torch._subclasses.fake_tensor import FakeTensorMode

    dev = device or trace_device()
    set_mesh_rules(cell.rules or {})
    set_active_mesh(mesh)
    rec = TraceRecorder(dev, mesh.size() if mesh is not None else 1)
    t0 = time.perf_counter()
    with FakeTensorMode():
        args = cell.make_args(dev)
        rec.hold(_state_tensors(args))
        with rec:
            out = cell.step(*args)
        updated = [args[i] for i in cell.donate_argnums] \
            if cell.kind == "train" else []
        rec.finish(_state_tensors(out), _state_tensors(tuple(updated)))
    rec.trace.seconds = time.perf_counter() - t0
    return rec.trace

"""Shared model substrate (port of ``src/repro/models/common.py``): config,
logical-axis sharding on a ``torch.distributed`` device mesh, norms, RoPE,
the dense FFNs, chunked cross-entropy.

Sharding.  The reference maps each tensor's logical axes to mesh axes by
rules (``DEFAULT_RULES``) and lets GSPMD place the compute.  The port keeps
the rules and resolves them to DTensor placements (``logical_sharding``)
where tensors are made: parameters and optimizer state live on the mesh as
DTensors and a batch is split over the data axes (the "batch" rule's,
``data_axes``), each data rank holding its contiguous rows.  Each layer
gathers its weights over the data axes and keeps their "model" split
(``whole(w, keep=("model",))``: the FSDP all-gather, whose backward pass
sums the gradient over the data axes into this rank's shard), and computes
its share of the heads, mlp columns, experts, vocab rows or SSD heads
(``Split``, ``take``) between Megatron's collectives over "model":
``fan_out_model`` where split compute starts (identity forward, its
gradient summed) and ``combine_model`` where it ends (the partial outputs
summed, identity backward).  So the work over "model" is split as GSPMD
splits it from the reference's constraints, and ``shard``, that
constraint, is the identity here.  Under ``gather_bf16`` a layer's
weights are gathered whole, as the reference's ``model.py:325-332`` does,
and its compute is replicated over "model".

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
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


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
    # 'global': sort-based dispatch over the whole batch.  'local':
    # replicated-routing expert parallelism over an active mesh's "model"
    # axis (moe.moe_forward_local); without such a mesh it takes the global
    # path, as the reference does.
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
    # pattern in training ("full" | "dots" | "none"; model.py).  unroll,
    # the reference's scan knob, is kept for field parity and changes
    # nothing here: the layers run in a Python loop.  gather_bf16 gathers
    # each layer's weights whole on a mesh, as the reference's FSDP-payload
    # knob does, so the layer's compute is replicated over "model" (a
    # weight is gathered in its own dtype).
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
# logical-axis sharding
# ---------------------------------------------------------------------------
# logical axis -> mesh axes.  'fsdp' rules shard the big weight dimension over
# the data axis (ZeRO-3 style); 'tp' rules shard heads/ff/experts/vocab over
# the model axis.  The pod axis extends data parallelism.
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_kv": None,          # long-context decode reshards the cache over this
    "embed": "data",         # fsdp shard of weight d_model dims
    "heads": "model",
    "kv_heads": None,        # few kv heads: replicate
    "head_dim": None,
    "mlp": "model",
    "experts": "model",      # expert parallelism
    "exp_cap": ("pod", "data"),  # expert capacity dim: shard tokens over data
    "expert_mlp": None,
    "vocab": "model",
    "lora": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "act_embed": None,       # activation d_model dim
}

_MESH_RULES: dict[str, Any] = dict(DEFAULT_RULES)


def set_mesh_rules(rules: dict[str, Any]) -> None:
    global _MESH_RULES
    _MESH_RULES = dict(DEFAULT_RULES)
    _MESH_RULES.update(rules)


def Mesh_Rules() -> dict[str, Any]:
    return dict(_MESH_RULES)


def _resolve(axes: tuple[str | None, ...], mesh) -> tuple:
    """The reference's ``PartitionSpec`` entries for logical ``axes`` (a
    mesh axis name, a tuple of them, or None per dim) over ``mesh``'s
    ``mesh_dim_names`` (None: every rule's axes)."""
    spec = []
    names = set(mesh.mesh_dim_names) if mesh is not None else None
    used: set = set()  # a mesh axis may shard at most one dim
    for ax in axes:
        if ax is None:
            spec.append(None)
            continue
        m = _MESH_RULES.get(ax, None)
        if m is None:
            spec.append(None)
            continue
        cand = m if isinstance(m, tuple) else (m,)
        kept = tuple(x for x in cand
                     if (names is None or x in names) and x not in used)
        used.update(kept)
        if not kept:
            spec.append(None)
        elif len(kept) == 1:
            spec.append(kept[0])
        else:
            spec.append(kept)
    return tuple(spec)


def spec_placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of a resolved spec: ``Shard(d)`` on each mesh dim
    that shards tensor dim ``d``, ``Replicate()`` on the others.  A dim
    sharded over several mesh axes (``("pod", "data")``) is split over
    them outer first, which is the reference's order only while the tuple
    is in mesh order; another order would need a strided shard."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, sp in enumerate(spec):
        if sp is None:
            continue
        axes = sp if isinstance(sp, tuple) else (sp,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {sp} of dim {d} is not in mesh order "
                             f"{tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def logical_sharding(axes: tuple[str | None, ...], mesh) -> tuple:
    """The placements over ``mesh``'s dims of a tensor with logical
    ``axes`` (the reference returns a ``NamedSharding``)."""
    return spec_placements(_resolve(axes, mesh), mesh)


_ACTIVE_MESH = None


def set_active_mesh(mesh) -> None:
    """Install the mesh the model runs on (None = single device)."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def active_mesh():
    return _ACTIVE_MESH


def shard(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """The reference's sharding constraint by logical axis names.  The
    identity: the port has no compiler to steer.  Its layers compute, on
    local tensors, the layout the reference's constraints ask GSPMD for:
    each model rank its share of the heads, mlp columns, experts, vocab
    rows or SSD heads (``Split``), between Megatron's column- and
    row-parallel collectives (``fan_out_model`` where a split region
    starts, ``combine_model`` where it ends)."""
    return x


# ---------------------------------------------------------------------------
# collectives over a mesh, with the backward passes the model needs
# ---------------------------------------------------------------------------
def _dim_size(mesh, axis: str) -> int:
    """The size of ``mesh``'s dim ``axis`` (1 where it has none)."""
    names = list(mesh.mesh_dim_names)
    return mesh.size(names.index(axis)) if axis in names else 1


def _rule_axes(mesh, axes: tuple, i: int) -> tuple[str, ...]:
    """The mesh dims the rules give entry ``i`` of logical ``axes``."""
    if mesh is None:
        return ()
    sp = _resolve(axes, mesh)[i]
    if sp is None:
        return ()
    return sp if isinstance(sp, tuple) else (sp,)


def data_axes(mesh) -> tuple[str, ...]:
    """``mesh``'s dims that split the batch, outer first: the "batch"
    rule's (none under ``long_500k``'s rules, whose one row every rank
    holds)."""
    return _rule_axes(mesh, ("batch",), 0)


def position_axes(mesh) -> tuple[str, ...]:
    """The mesh dims that split a KV cache's positions, outer first: the
    "seq_kv" rule's less the batch's (``decode_32k``: "model";
    ``long_500k``: every dim; the other shapes: none)."""
    return _rule_axes(mesh, ("batch", "seq_kv"), 1)


def axes_size(mesh, axes) -> int:
    """The number of ranks over ``mesh``'s dims ``axes``."""
    n = 1
    for a in axes:
        n *= _dim_size(mesh, a)
    return n


def axes_rank(mesh, axes) -> int:
    """This rank's index over ``mesh``'s dims ``axes``, outer axis major:
    its block of a dim split over them."""
    r = 0
    for a in axes:
        r = r * _dim_size(mesh, a) + mesh.get_local_rank(a)
    return r


def data_size(mesh) -> int:
    """Number of data ranks (1 without a mesh)."""
    return axes_size(mesh, data_axes(mesh))


def data_rank(mesh) -> int:
    """This rank's index among the data ranks, outer axis major: its rows
    of a batch split over the data axes are the ``data_rank``-th block."""
    return axes_rank(mesh, data_axes(mesh))


def model_size(mesh) -> int:
    """Number of model ranks (1 without a mesh)."""
    return _dim_size(mesh, "model") if mesh is not None else 1


def _sum_over(x: torch.Tensor, mesh, axes,
              op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced (summed) over the ranks of ``mesh``'s dims ``axes``
    (a copy)."""
    x = x.clone()
    for a in axes:
        if _dim_size(mesh, a) > 1:
            dist.all_reduce(x, op=op, group=mesh.get_group(a))
    return x


def max_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The elementwise maximum of ``x`` over ``axes``' ranks (no
    gradient)."""
    return _sum_over(x.detach(), mesh, axes, dist.ReduceOp.MAX)


def sum_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of ``x`` over ``axes``' ranks (no gradient)."""
    return _sum_over(x.detach(), mesh, axes)


class _Redistribute(torch.autograd.Function):
    """This rank's piece of a tensor laid out by ``placements`` -> its piece
    under ``target``.  Backward: the incoming gradient is partial over the
    data axes (each data rank saw its own rows) and equal over the others;
    it is summed over the data axes and laid out by ``placements`` again
    (where ``target`` keeps a model-axis split, each rank keeps its
    slice)."""

    @staticmethod
    def forward(ctx, local, mesh, placements, target):
        ctx.mesh, ctx.placements, ctx.target = mesh, placements, target
        out = DTensor.from_local(local, mesh, placements, run_check=False
                                 ).redistribute(mesh, target).to_local()
        # a new tensor even where the layout does not change (the same
        # storage at the same offset; a fake tensor has no data pointer)
        same = (out.untyped_storage()._cdata == local.untyped_storage()._cdata
                and out.storage_offset() == local.storage_offset())
        return out.clone() if same else out

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        dp = data_axes(mesh)
        src = [Partial() if a in dp else t
               for a, t in zip(mesh.mesh_dim_names, ctx.target)]
        out = DTensor.from_local(g.contiguous(), mesh, src, run_check=False
                                 ).redistribute(mesh, ctx.placements)
        return out.to_local(), None, None, None


def _relayout(local: torch.Tensor, mesh, placements, target) -> torch.Tensor:
    """``_Redistribute`` on a plain local tensor (no collective on a mesh of
    one rank)."""
    if mesh.size() == 1:
        return local
    return _Redistribute.apply(local, mesh, tuple(placements), tuple(target))


def whole(t: torch.Tensor, keep: tuple[str, ...] = ()) -> torch.Tensor:
    """A parameter for compute: a DTensor gathered over every mesh dim but
    those named in ``keep`` (the FSDP all-gather; its gradient is summed
    over the data axes and lands in this rank's shard), a plain tensor as
    it is.  ``keep=("model",)`` leaves a weight split on "model" split:
    this rank's share of its heads, columns, experts or vocab rows."""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    target = [p if a in keep else Replicate()
              for a, p in zip(mesh.mesh_dim_names, t.placements)]
    return _relayout(t.to_local(), mesh, t.placements, target)


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This data rank's rows (dim 0) of a batch -> the whole batch, in the
    global row order.  Backward: each rank's gradient summed over the data
    ranks, then its own rows kept."""
    dp = data_axes(mesh)
    pl = [Shard(0) if a in dp else Replicate() for a in mesh.mesh_dim_names]
    return _relayout(x, mesh, pl, [Replicate()] * len(pl))


class _ModelSum(torch.autograd.Function):
    """Megatron's collectives over the "model" axis.  ``combine``: the
    forward pass sums the model ranks' partial outputs, the backward pass
    is the identity (the compute after it is replicated, so each rank's
    gradient is already the whole).  ``fan_out``: the other way round (what
    follows is split over the model ranks, so each one's gradient is
    partial).  ``sum``: a sum both ways (a statistic of split compute that
    split compute uses, as the gated norm's sum of squares)."""

    @staticmethod
    def forward(ctx, x, mesh, mode):
        ctx.mesh, ctx.mode = mesh, mode
        if mode == "fan_out":
            return x.view_as(x)
        return _sum_over(x, mesh, ("model",))

    @staticmethod
    def backward(ctx, g):
        if ctx.mode == "combine":
            return g, None, None
        return _sum_over(g, ctx.mesh, ("model",)), None, None


def combine_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum of the model ranks' partial outputs; identity backward."""
    return _ModelSum.apply(x, mesh, "combine")


def fan_out_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Identity forward; the model ranks' partial gradients summed."""
    return _ModelSum.apply(x, mesh, "fan_out")


def sum_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum over the model ranks, forward and backward."""
    return _ModelSum.apply(x, mesh, "sum")


@dataclass(frozen=True)
class Split:
    """This model rank's share of a dim of ``n`` units (heads, mlp columns,
    experts, vocab rows, SSD heads) split over the "model" axis: units
    ``[lo, lo + cnt)``, ``ceil(n / M)`` a rank, the last ranks' shares
    shorter or empty where ``M`` does not divide ``n`` (GSPMD pads such a
    split).  ``mesh`` is None where the dim is not split: no mesh, one
    model rank, or a weight the rules leave whole (mamba2's vocab of 50,280
    over 16 ranks; every layer weight under ``gather_bf16``); the compute is
    then replicated and nothing is communicated."""
    n: int
    lo: int
    cnt: int
    mesh: Any = None

    @property
    def on(self) -> bool:
        return self.mesh is not None

    @property
    def chunk(self) -> int:
        return -(-self.n // model_size(self.mesh))


def model_split(n: int, w: torch.Tensor, dim: int, unit: int = 1) -> Split:
    """The split of a dim of ``n`` units of ``unit`` entries under the
    active mesh, as its weight ``w`` holds it along ``dim``: split where
    ``w`` holds less than all of it (the rules split it over "model")."""
    mesh = active_mesh()
    if model_size(mesh) == 1 or w.shape[dim] == n * unit:
        return Split(n, 0, n)
    return share(n, mesh)


def share(n: int, mesh) -> Split:
    """This rank's share of ``n`` units split over ``mesh``'s model
    ranks."""
    c = -(-n // model_size(mesh))
    lo = min(mesh.get_local_rank("model") * c, n)
    return Split(n, lo, min(c, n - lo), mesh)


def gather_model(x: torch.Tensor, dim: int, s: Split,
                 unit: int = 1) -> torch.Tensor:
    """This rank's share ``x`` of a dim split as ``s`` (``unit`` entries a
    unit along ``dim``) -> the whole dim on every model rank: each share
    padded to ``s.chunk`` units, all-gathered, the padding dropped.
    Backward: the gradient, partial on each rank (the whole feeds split
    compute), summed over the model ranks and this rank's share kept."""
    if not s.on:
        return x
    pad = (s.chunk - s.cnt) * unit
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim)
    return _Exchange.apply(x, dim, s.mesh, ("model",), False).narrow(
        dim, 0, s.n * unit)


def take(s: Split, w: torch.Tensor, dim: int, unit: int = 1) -> torch.Tensor:
    """This rank's units of weight ``w`` along ``dim`` for compute split as
    ``s``: a weight split on "model" at unit boundaries as it is; one whose
    even split of entries cuts units (llava's 56 heads over 16 ranks)
    gathered first; a whole one (the rules leave it replicated) narrowed,
    its gradient summed over the model ranks."""
    if not s.on:
        return w
    M, width = model_size(s.mesh), w.shape[dim]
    if width == s.n * unit:
        w = fan_out_model(w, s.mesh)
    elif s.n % M == 0:
        return w
    else:
        r = s.mesh.get_local_rank("model")
        w = gather_model(w, dim, Split(width * M, r * width, width, s.mesh))
    return w.narrow(dim, s.lo * unit, s.cnt * unit)


def _over(x: torch.Tensor, dim: int, mesh, axes, scatter: bool):
    """``x`` reduce-scattered (``scatter``: summed over the ranks of
    ``mesh``'s dims ``axes``, this rank's block of ``dim`` kept) or
    all-gathered (the ranks' blocks of ``dim`` joined in rank order)."""
    axes = [a for a in axes if _dim_size(mesh, a) > 1]
    x = x.movedim(dim, 0)
    for a in (axes if scatter else reversed(axes)):
        n, grp = _dim_size(mesh, a), mesh.get_group(a)
        x = x.contiguous()
        if scatter:
            out = x.new_empty((x.shape[0] // n,) + x.shape[1:])
            dist.reduce_scatter_tensor(out, x, group=grp)
        else:
            out = x.new_empty((x.shape[0] * n,) + x.shape[1:])
            dist.all_gather_into_tensor(out, x, group=grp)
        x = out
    return x.movedim(0, dim)


class _Exchange(torch.autograd.Function):
    """``_over``'s reduce-scatter and all-gather, each the other's
    adjoint."""

    @staticmethod
    def forward(ctx, x, dim, mesh, axes, scatter):
        ctx.args = (dim, mesh, axes, not scatter)
        return _over(x, dim, mesh, axes, scatter)

    @staticmethod
    def backward(ctx, g):
        return (_over(g, *ctx.args),) + (None,) * 4


def scatter_data(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """Each data rank's partial ``x`` -> their sum's block of ``dim`` that
    this data rank owns (a reduce-scatter; backward: an all-gather)."""
    if data_size(mesh) == 1:
        return x
    return _Exchange.apply(x, dim, mesh, data_axes(mesh), True)


def gather_data(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The data ranks' blocks of ``dim`` joined in rank order (an
    all-gather; backward: the gradient, partial on each rank, summed and
    this rank's block kept)."""
    if data_size(mesh) == 1:
        return x
    return _Exchange.apply(x, dim, mesh, data_axes(mesh), False)


class _DataMean(torch.autograd.Function):
    """Mean over the data ranks, forward and backward (its own adjoint
    when every rank's loss holds the mean)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _sum_over(x, mesh, data_axes(mesh)) / data_size(mesh)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        return _sum_over(g, mesh, data_axes(mesh)) / data_size(mesh), None


def mean_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of ``x`` over the data ranks (``x`` on one data rank)."""
    if data_size(mesh) == 1:
        return x
    return _DataMean.apply(x, mesh)


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
                          unroll: bool = False,
                          vocab: Split | None = None) -> torch.Tensor:
    """Mean CE without materializing (B, S, V) logits: a loop over sequence
    chunks (the forward value; ``unroll`` is the reference's scan knob).

    ``vocab`` split (``head`` holds this model rank's vocab columns, as
    the reference constrains the logits, ``common.py:309``): each rank
    computes its columns' logits; the log-sum-exp takes the maximum and the
    sum of exponentials over the model ranks, the target logit comes from
    the rank that owns it, and the backward pass is the vocab-parallel
    one (each rank's softmax less its one-hot columns)."""
    B, S, d = h.shape
    split = vocab is not None and vocab.on
    if split:
        h = fan_out_model(h, vocab.mesh)
    nchunk = max(S // chunk, 1)
    chunk = S // nchunk
    h_c = h.reshape(B, nchunk, chunk, d)
    y_c = labels.reshape(B, nchunk, chunk)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(nchunk):
        logits = dot(h_c[:, i], head).float()                # (B, c, V)
        y = y_c[:, i, :, None].long()
        if split:
            m = max_over(logits.amax(-1, keepdim=True), vocab.mesh,
                         ("model",))
            se = combine_model(torch.exp(logits - m).sum(-1), vocab.mesh)
            lse = m[..., 0] + torch.log(se)
            local = y - vocab.lo
            mine = (local >= 0) & (local < vocab.cnt)
            tgt = torch.gather(logits, -1,
                               local.clamp(0, max(vocab.cnt - 1, 0)))
            tgt = combine_model(torch.where(mine, tgt, 0.0)[..., 0],
                                vocab.mesh)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            tgt = torch.gather(logits, -1, y)[..., 0]
        total = total + torch.sum(lse - tgt)
    return total / (B * S)


def lookup(table: torch.Tensor, tokens: torch.Tensor,
           vocab: Split) -> torch.Tensor:
    """The rows of ``table`` at ``tokens``.  Split: this model rank looks
    up its own vocab rows, writes zeros for the others, and the model
    ranks' rows are summed (each token's row comes from one rank)."""
    if not vocab.on:
        return table[tokens]
    local = tokens - vocab.lo
    mine = ((local >= 0) & (local < vocab.cnt))[..., None]
    rows = table[local.clamp(0, max(vocab.cnt - 1, 0))]
    return combine_model(torch.where(mine, rows, 0), vocab.mesh)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) without ``F.softplus``'s linear cut
    above 20."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


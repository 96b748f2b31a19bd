"""Exact cost analysis of a cell's recorded step (port of
``src/repro/launch/hlo_analysis.py``).

The reference parses the optimized HLO text of a compiled cell: it counts
the flops of every dot and the wire bytes of every collective, and
multiplies each while-loop body by its trip count (XLA's own
``cost_analysis`` counts a scanned body once).  The port has no XLA and no
HLO.  Its stand-in for the optimized HLO is a ``Trace``: the record of one
run of the cell's step on fake tensors (``launch.steps.lower_cell``), made
by ``TraceRecorder``, a ``TorchDispatchMode`` that sees

  * every aten op the step runs, with its operands' and results' shapes
    and dtypes (an op on DTensors is let through to DTensor first, so what
    is recorded is the local op each rank runs, on its local shapes);
  * every collective: the functional ones (``_c10d_functional.*``, which
    DTensor's redistributions make) with the group size their group name
    resolves to, and the in-place ones of ``torch.distributed``
    (``c10d.allreduce_`` ...) with their process group's size; and the
    nodes of 8 GPUs that the group's ranks span (``launch.mesh.NET``);
  * where each op came from: the nearest frame of the ``repro_torch``
    package (``file:line function``), or in the backward pass the autograd
    node that runs it (``backward MmBackward0``).  This is the counterpart
    of the reference's ``op_name`` metadata.  The model's modules are
    containers its forward never calls, so ``ModuleTracker`` would see only
    its "Global" scope;
  * the live bytes of every fake storage (argument, made, freed), so the
    peak of what the step holds on a device.

What DTensor's sharding propagation runs to learn an output's global
shape (an op on fake tensors of the global shapes) is left out: a real
run runs it on a fake mode of its own, and it is not the program.

The step runs eagerly, its loops in Python, so the record is unrolled: a
loop body appears once per pass, and the totals need no trip-count
multiplier.  They are the same totals as the reference's trip-aware ones.

    flops       = the matrix products: mm, addmm, bmm, baddbmm, _scaled_mm
                  and scaled-dot-product attention, counted as
                  ``torch.utils.flop_counter`` counts them; convolutions
                  and elementwise ops are not counted, as in the reference
                  (on these models products are >98 % of compute)
    wire bytes  = per collective, the rule of the reference's
                  ``_collective_wire_bytes`` for its kind, g its group size;
                  those of groups that span more than one node also apart,
                  since they cross the network (the roofline prices them so)

Not ported: the reference's parser of XLA text (computations, trip counts,
dimension numbers), since the port has no HLO, and its
``_tpu_lowering_adjustment``, which models rewrites of the TPU's XLA
pipeline (reduce-scatter creation, convert sinking): the port counts the
collectives its program hands to NCCL, as it hands them over.
"""
from __future__ import annotations

import sys
import weakref
from dataclasses import dataclass, field
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.mesh import NET

_PACKAGE = str(Path(__file__).resolve().parents[1])
_THIS = str(Path(__file__).resolve())

#: the reference's short dtype names, for the collectives' shape column
_DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.bfloat16: "bf16", torch.float16: "f16",
    torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
    torch.float64: "f64", torch.float8_e4m3fn: "f8e4m3fn",
    torch.float8_e5m2: "f8e5m2",
}

#: the matrix products whose flops count (the flop counter's rules); its
#: convolutions are left out
_PRODUCTS = {op for op in flop_registry
             if "conv" not in str(op) and "flex" not in str(op)}

#: collective ops -> the reference's kind; the functional ones' results
#: are their outputs, the in-place ones' their first argument
_FUNCTIONAL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
_INPLACE = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "broadcast_": "broadcast",
}

#: metadata queries that move nothing and need no record
_SKIP = {"prim.device.default", "aten.size.default", "aten.stride.default",
         "aten.storage_offset.default", "aten.numel.default",
         "aten.dim.default", "aten.is_contiguous.default",
         "aten.sym_size.default", "aten.sym_stride.default",
         "aten.sym_numel.default", "aten.sym_storage_offset.default",
         "aten.promote_types.default"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _spec(t: torch.Tensor) -> tuple:
    return tuple(t.shape), _DTYPE_NAMES.get(t.dtype, str(t.dtype))


@dataclass
class OpRecord:
    """One op of the step: its name (``aten.mm.default``), its operands'
    and results' ``(shape, dtype)``, its flops (matrix products), the
    collective's kind, group size, the nodes its group spans and result
    bytes (else None, 0, 1, 0), the bytes it reads and writes (0 for a
    view), and where it came from."""
    op: str
    inputs: list
    outputs: list
    flops: float = 0.0
    coll: str | None = None
    group: int = 0
    nodes: int = 1
    coll_bytes: int = 0
    nbytes: int = 0
    where: str = "?"


@dataclass
class Trace:
    """The record of one run of a step: its ops, the device its fake
    tensors lay on, the mesh's size, and its memory (bytes on one device:
    ``argument``, ``output``, ``alias``, ``peak``)."""
    ops: list = field(default_factory=list)
    device: str = "cpu"
    n_devices: int = 1
    memory: dict = field(default_factory=dict)
    seconds: float = 0.0


def _group(func, args) -> tuple[int, int]:
    """The size of the process group a collective runs over, from its
    group name (functional) or its process group argument (in place), and
    the nodes its ranks span (``NET``'s layout)."""
    pg = None
    if func.namespace in ("_c10d_functional", "c10d_functional"):
        for a in reversed(args):
            if isinstance(a, str):
                try:
                    pg = dist.distributed_c10d._resolve_process_group(a)
                    break
                except RuntimeError:  # a reduce op's name ("sum")
                    continue
    else:
        for a in args:
            if isinstance(a, torch.ScriptObject):
                try:
                    pg = dist.ProcessGroup.unbox(a)
                    break
                except RuntimeError:  # a ReduceOp
                    continue
    if pg is None:
        return 1, 1
    per_node = NET["gpus_per_node"]
    return pg.size(), len({r // per_node
                           for r in dist.get_process_group_ranks(pg)})


def _where(is_bw: bool) -> str | None:
    """Where in the package an op came from: its nearest frames (this
    module aside), each run of frames in one file as the outermost of the
    run, the nearest three files, outer first; else the autograd node that
    runs it, else "?".  None while DTensor's sharding propagation runs the
    op: it runs it on fake tensors of the global shapes to learn its
    output's, under the active fake mode (a real run uses a fake mode of
    its own), so the op is not the program's.  One walk up the stack:
    propagation's frames lie below the package's."""
    frames: list[tuple[str, str]] = []
    f = sys._getframe(2)
    while f is not None:
        code = f.f_code
        fn = code.co_filename
        if fn.startswith(_PACKAGE):
            if fn != _THIS:
                here = f"{fn[len(_PACKAGE) + 1:]}:{f.f_lineno} {code.co_name}"
                if frames and frames[-1][0] == fn:
                    frames[-1] = (fn, here)
                elif len(frames) == 3:
                    break
                else:
                    frames.append((fn, here))
        elif not frames and "propagate_tensor_meta" in code.co_name and \
                fn.endswith("_sharding_prop.py"):
            return None
        f = f.f_back
    if frames:
        return " / ".join(h for _, h in reversed(frames))
    if is_bw:
        node = torch._C._current_autograd_node()
        if node is not None:
            return f"backward {node.name()}"
    return "?"


class TraceRecorder(TorchDispatchMode):
    """Records a ``Trace`` of everything run under it, and follows the
    bytes of every storage made: ``hold`` the arguments first, then run
    the step inside the recorder, then ``finish`` with the step's result
    and the tensors it updated in place."""

    def __init__(self, device: str = "cpu", n_devices: int = 1):
        super().__init__()
        self.trace = Trace(device=str(device), n_devices=n_devices)
        self.live = 0
        self.peak = 0
        self._sizes: dict[int, int] = {}
        self._refs: dict[int, weakref.ref] = {}
        self._args: set[int] = set()
        self._arg_bytes = 0

    # ---- storages ----
    def _free(self, key: int, _ref) -> None:
        self.live -= self._sizes.pop(key, 0)
        self._refs.pop(key, None)
        self._args.discard(key)  # the id may name a new storage later

    def _track(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = id(st)
        if key not in self._refs:
            self._sizes[key] = st.nbytes()
            self._refs[key] = weakref.ref(st, lambda r, k=key: self._free(k, r))
            self.live += self._sizes[key]
            self.peak = max(self.peak, self.live)
        return key

    def hold(self, tensors) -> None:
        """Count ``tensors`` (local tensors) as the step's arguments."""
        for t in tensors:
            key = self._track(t)
            if key not in self._args:
                self._args.add(key)
                self._arg_bytes += self._sizes[key]

    def finish(self, outputs, updated=()) -> dict:
        """The step's memory: arguments (as they were held), outputs (its
        result and the argument tensors it updated in place), alias
        (outputs that are arguments), and peak live bytes."""
        out_keys = {self._track(t) for t in list(outputs) + list(updated)}
        arg = self._arg_bytes
        out = sum(self._sizes.get(k, 0) for k in out_keys)
        alias = sum(self._sizes.get(k, 0) for k in out_keys & self._args)
        self.trace.memory = {"argument": arg, "output": out, "alias": alias,
                             "peak": self.peak}
        return self.trace.memory

    # ---- ops ----
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # DTensor desugars it into local ops and collectives, which
            # come back here
            return NotImplemented
        out = func(*args, **kwargs)
        name = str(func)
        if name in _SKIP:
            return out
        where = _where(torch._C._current_autograd_node() is not None)
        if where is None:
            return out
        flat_in = [a for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)]
        flat_out = [o for o in tree_flatten(out)[0]
                    if isinstance(o, torch.Tensor)]
        for o in flat_out:
            self._track(o)
        rec = OpRecord(name, [_spec(a) for a in flat_in],
                       [_spec(o) for o in flat_out],
                       nbytes=0 if func.is_view else
                       sum(_nbytes(t) for t in flat_in + flat_out),
                       where=where)
        packet = func._overloadpacket
        if packet in _PRODUCTS:
            rec.flops = float(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        op_name = func._schema.name.split("::")[-1]
        kind = None
        if func.namespace in ("_c10d_functional", "c10d_functional"):
            kind = _FUNCTIONAL.get(op_name)
            res = flat_out
        elif func.namespace == "c10d":
            kind = _INPLACE.get(op_name)
            res = [a for a in tree_flatten(args[0])[0]
                   if isinstance(a, torch.Tensor)]
        if kind is not None:
            rec.coll = kind
            rec.group, rec.nodes = _group(func, args)
            rec.coll_bytes = sum(_nbytes(t) for t in res)
            rec.outputs = [_spec(t) for t in res]
        self.trace.ops.append(rec)
        return out


# ---------------------------------------------------------------------------
# the analysis
# ---------------------------------------------------------------------------
def _collective_wire_bytes(kind: str, b: float, g: int) -> float:
    """Wire bytes a device moves for one collective of ``kind`` whose
    result holds ``b`` bytes, over a group of ``g``: the reference's rule
    (ring algorithms; a broadcast receives its result once)."""
    if g <= 1:
        return 0.0
    f = (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * b * f
    if kind in ("collective-permute", "broadcast"):
        return float(b)
    if kind == "all-gather":
        return b * f  # b is the gathered output
    if kind == "reduce-scatter":
        return b * g * f  # b is the small output: the input is b * g
    return b * f  # all-to-all


@dataclass
class HloCost:
    flops: float = 0.0
    coll_wire_bytes: float = 0.0
    # the part of coll_wire_bytes whose groups span more than one node
    coll_wire_bytes_internode: float = 0.0
    coll_counts: dict = field(default_factory=dict)
    # (kind, shape, where) -> [wire_bytes_total, count]
    coll_detail: dict = field(default_factory=dict)
    # bytes every op reads and writes, unfused (views aside): a diagnostic
    bytes_accessed: float = 0.0

    def top_collectives(self, n: int = 15) -> list:
        rows = [
            {"kind": k[0], "shape": k[1], "op": k[2],
             "wire_bytes": v[0], "count": v[1]}
            for k, v in self.coll_detail.items()
        ]
        rows.sort(key=lambda r: -r["wire_bytes"])
        return rows[:n]


def _shape_str(spec) -> str:
    shape, dt = spec
    return f"{dt}[{','.join(str(d) for d in shape)}]"


def analyze_trace(trace: Trace, n_devices: int) -> HloCost:
    """Flops, wire bytes and collective counts of one device's step (the
    reference's ``analyze_hlo`` over the recorded trace; ``n_devices`` is
    the group size of a collective whose group is unknown, its ranks taken
    as the first ``n_devices``)."""
    total = HloCost()
    per_node = NET["gpus_per_node"]
    for r in trace.ops:
        total.flops += r.flops
        total.bytes_accessed += r.nbytes
        if r.coll is None:
            continue
        g, nodes = (r.group, r.nodes) if r.group else (
            n_devices, -(-n_devices // per_node))
        wb = _collective_wire_bytes(r.coll, r.coll_bytes, g)
        total.coll_wire_bytes += wb
        if nodes > 1:
            total.coll_wire_bytes_internode += wb
        total.coll_counts[r.coll] = total.coll_counts.get(r.coll, 0) + 1
        shape = _shape_str(r.outputs[0]) if r.outputs else (
            _shape_str(r.inputs[0]) if r.inputs else "?")
        key = (r.coll, shape, r.where[-120:])
        cur = total.coll_detail.get(key, [0.0, 0])
        total.coll_detail[key] = [cur[0] + wb, cur[1] + 1]
    return total

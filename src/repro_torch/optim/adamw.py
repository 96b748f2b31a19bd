"""AdamW with the reference's semantics (port of ``src/repro/optim/adamw.py``).

``torch.optim.AdamW`` differs from the reference's optimizer in four places,
so this is a ``torch.optim.Optimizer`` of its own:

  * global-norm gradient clipping, ``min(1, clip_norm / (gnorm + 1e-9))``
    over every gradient of every group (``clip_grad_norm_`` adds 1e-6);
  * weight decay added to the update of matrices only (``ndim >= 2``), not
    of norms and biases;
  * bias corrections and the update in float32, cast back to the
    parameter's dtype;
  * an optional int8 second moment in the sqrt domain with per-channel
    scales over the last axis (8-bit-Adam-style).

The reference stacks the layers of a segment along a leading axis, so the
decay rule sees a layer's norm scale as a matrix.  A parameter group with
``stacked=True`` holds single layers of such stacks (what
``LanguageModel.param_groups`` returns): the rule counts their layer axis,
and the port decays what the reference decays.

State: ``state["step"]`` (an int32 scalar, the reference's global step) and
per parameter ``{"m", "v"}`` or, with ``quantize_v``, ``{"m", "vq", "vs"}``
in float32 / int8, the reference's layout
(``models.convert.{to,from}_reference_opt_state`` carry it across).

On a mesh the parameters are DTensors and so are their gradients and
moments, each laid out as its parameter (``state_axes``, the reference's
rule, gives the same): the global norm sums every element once over the
whole tensors, and a quantized second moment's scale is the whole row's
maximum, replicated over the mesh dims that split the row.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    """Linear warmup to ``base_lr``, then a cosine to 0 at ``total``;
    evaluated in float32 as the reference does."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr


_Q_BLOCK = 128


def _quantize_i8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-wise symmetric int8 quantization of the flattened tensor."""
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, (-flat.shape[0]) % _Q_BLOCK))
    blocks = flat.reshape(-1, _Q_BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dequantize_i8(q: torch.Tensor, scale: torch.Tensor,
                   shape) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def _quantize_v(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Second moment quantized in the SQRT domain (linear int8 on v zeroes
    small entries and the m / (sqrt(v) + eps) update explodes; sqrt errors
    only shrink updates), with per-channel scales over the last axis."""
    r = torch.sqrt(v)
    scale = torch.amax(torch.abs(r), dim=-1, keepdim=True) / 127.0 + 1e-12
    if isinstance(scale, DTensor):  # laid out as state_axes' "vs"
        last = v.ndim - 1
        scale = scale.redistribute(v.device_mesh, [
            Replicate() if isinstance(pl, Shard) and pl.dim == last else pl
            for pl in v.placements])
    q = torch.clamp(torch.round(r / scale), 0, 127).to(torch.int8)
    return q, scale.float()


def _dequantize_v(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    r = q.float() * scale
    return (r * r).reshape(shape)


class AdamW(torch.optim.Optimizer):
    """``AdamW(params, lr=3e-4, ...)``: ``lr`` is a float or a callable of
    the 1-based step (``cosine_schedule``); ``clip_norm`` and
    ``quantize_v`` hold for every group."""

    def __init__(self, params, lr: float | Callable = 3e-4, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0,
                 quantize_v: bool = False):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay,
                                      stacked=False))
        self.clip_norm = clip_norm
        self.quantize_v = quantize_v
        self.state["step"] = torch.zeros((), dtype=torch.int32)

    def moments(self, p: torch.Tensor) -> dict:
        """``p``'s state ``{"m", "v"}`` or ``{"m", "vq", "vs"}``, made
        (zeros, as the reference's ``init``) on first use."""
        st = self.state[p]
        if not st:
            st["m"] = torch.zeros_like(p, dtype=torch.float32)
            if self.quantize_v:
                st["vq"], st["vs"] = _quantize_v(torch.zeros_like(st["m"]))
            else:
                st["v"] = torch.zeros_like(st["m"])
        return st

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        # the step, learning rate and bias corrections stay 0-d float32
        # tensors (no host read: the dry run traces this on fake tensors);
        # as scalars of the update they round as Python floats would
        step = self.state["step"] + 1
        grads = {p: p.grad if p.grad is not None else torch.zeros_like(p)
                 for g in self.param_groups for p in g["params"]}
        if not grads:
            return loss
        # global-norm clip over every gradient
        gnorm = torch.sqrt(sum(torch.sum(torch.square(d.float()))
                               for d in grads.values()))
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        f32 = torch.float32
        step_f = step.to(f32)
        for group in self.param_groups:
            lr = group["lr"]
            lr = lr(step).to(f32) if callable(lr) else lr
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            bc1 = 1.0 - torch.tensor(b1, dtype=f32) ** step_f
            bc2 = 1.0 - torch.tensor(b2, dtype=f32) ** step_f
            for p in group["params"]:
                st = self.moments(p)
                g = grads[p].float() * scale
                m = b1 * st["m"] + (1 - b1) * g
                v_prev = (_dequantize_v(st["vq"], st["vs"], p.shape)
                          if self.quantize_v else st["v"])
                v = b2 * v_prev + (1 - b2) * g * g
                delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
                if p.ndim + group["stacked"] >= 2:  # decay matrices only
                    delta = delta + group["weight_decay"] * p.float()
                p.copy_((p.float() - lr * delta).to(p.dtype))
                st["m"] = m
                if self.quantize_v:
                    st["vq"], st["vs"] = _quantize_v(v)
                else:
                    st["v"] = v
        self.state["step"] = step
        return loss

    def state_axes(self, param_axes) -> dict:
        """The logical axes of the reference's optimizer state for a
        parameter tree's axes: each moment inherits its parameter's; the
        quantized second moment's per-channel scale keeps the leading axes
        and has a broadcast last dim."""
        def ax(a):
            if isinstance(a, dict):
                return {k: ax(v) for k, v in a.items()}
            if isinstance(a, list):
                return [ax(v) for v in a]
            a = tuple(a)
            if self.quantize_v:
                vs = a[:-1] + (None,) if a else a
                return {"m": a, "vq": a, "vs": vs}
            return {"m": a, "v": a}
        return {"step": (), "mu": ax(param_axes)}

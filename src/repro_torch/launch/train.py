"""Training driver with checkpoint/restart, preemption handling and a
straggler watchdog (port of ``src/repro/launch/train.py``), on one card or
on a mesh:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 200 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt [--device cpu]

  * SIGTERM/SIGINT -> finish the current step, checkpoint, exit 42 (the
    cluster scheduler restarts the job, which auto-resumes from the latest
    checkpoint);
  * periodic + async checkpoints (host copy synchronous, write in the
    background), in the reference's layout: a checkpoint directory of
    either package resumes in the other;
  * a watchdog logs a warning if a step exceeds ``factor`` x the trailing
    median step time (straggler detection).

The config is forced to fp32 parameters and compute, as the reference's
``train`` does.

With a ``torch.distributed`` process group initialized (by the caller, one
process per device), ``train`` runs on a ``mesh_shape`` (data, model) mesh
over it, any shape whose product is the world size, (1, 1) included: as
the reference does, it builds the mesh, resets the sharding rules, makes
the mesh active, and lays the parameters and the optimizer state out by
their logical axes (DTensors).  Each data rank trains on its contiguous
rows of the same global batch, so the losses are the single device's.
Without a group, (1, 1) is the single-device path and any other shape
raises, as the reference's device check does.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import signal
import statistics
import sys
import threading
import time

import torch
import torch.distributed as dist

from repro_torch.ckpt import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import make_train_iterator
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import place_model, shardings_from_axes
from repro_torch.models import (
    active_mesh,
    init_params,
    set_active_mesh,
    set_mesh_rules,
    train_step_fn,
)
from repro_torch.models.common import data_rank, data_size
from repro_torch.models.convert import (
    from_reference_opt_state,
    load_reference_params,
    reference_tree,
    to_reference_opt_state,
    to_reference_params,
)
from repro_torch.optim import AdamW, cosine_schedule


class StepWatchdog:
    """Logs stragglers: steps slower than factor x trailing median."""

    def __init__(self, factor: float = 3.0, window: int = 20):
        self.factor = factor
        self.times: list[float] = []
        self.window = window
        self.warnings = 0

    def observe(self, dt: float) -> bool:
        slow = False
        if len(self.times) >= 5:
            med = statistics.median(self.times[-self.window:])
            if dt > self.factor * med:
                self.warnings += 1
                slow = True
                print(f"[watchdog] straggler step: {dt:.3f}s vs median {med:.3f}s",
                      flush=True)
        self.times.append(dt)
        return slow


def _any_rank(flag: bool, dev) -> bool:
    """``flag`` on any rank of the process group: every rank stops at the
    same step, whichever received the signal."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return flag
    t = torch.tensor([int(flag)], device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def _state(model, opt) -> dict:
    """The training state as the reference's checkpoint tree."""
    return {"params": to_reference_params(model),
            "opt": to_reference_opt_state(model, opt)}


def train(
    arch: str = "llama3.2-1b",
    *,
    smoke: bool = True,
    steps: int = 100,
    batch: int = 8,
    seq: int = 256,
    lr: float = 3e-4,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    mesh_shape: tuple[int, int] = (1, 1),
    log_every: int = 10,
    seed: int = 0,
    grad_compression: bool = False,
    on_step=None,
    device=None,
) -> dict:
    """Train ``arch`` on the synthetic stream; the result's ``"params"`` is
    the trained ``LanguageModel`` (it holds the parameters) and its
    ``"optimizer"`` the ``AdamW`` that holds the optimizer state.
    ``grad_compression`` is accepted and unused, as in the reference."""
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    cfg = dataclasses.replace(cfg, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    mesh = None
    if dist.is_initialized() or tuple(mesh_shape) != (1, 1):
        mesh = make_host_mesh(tuple(mesh_shape), device=dev)
        set_mesh_rules({})  # the batch's rule splits it over the data axes
    n_dp = data_size(mesh)
    r_dp = data_rank(mesh) if mesh is not None else 0
    if batch % n_dp:
        raise ValueError(f"batch {batch} does not divide over {n_dp} data "
                         f"ranks")
    rows = slice(r_dp * batch // n_dp, (r_dp + 1) * batch // n_dp)
    prev_mesh = active_mesh()
    if mesh is not None:
        set_active_mesh(mesh)
    try:
        return _train(cfg, mesh, rows, steps=steps, batch=batch, seq=seq,
                      lr=lr, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                      log_every=log_every, seed=seed, on_step=on_step,
                      dev=dev)
    finally:
        set_active_mesh(prev_mesh)


def _train(cfg, mesh, rows: slice, *, steps, batch, seq, lr, ckpt_dir,
           ckpt_every, log_every, seed, on_step, dev) -> dict:
    model = init_params(cfg, seed, device=dev)
    if mesh is not None:
        place_model(model, mesh)
    opt = AdamW(model.param_groups(),
                lr=cosine_schedule(lr, warmup=max(steps // 20, 1), total=steps))
    start = 0
    # one rank logs (every rank of a mesh computes the same losses)
    lead = not dist.is_initialized() or dist.get_rank() == 0

    ckpt = None
    if ckpt_dir:
        # made here: the log below writes into it before the first save
        pathlib.Path(ckpt_dir).mkdir(parents=True, exist_ok=True)
        ckpt = AsyncCheckpointer(ckpt_dir)
        last = latest_step(ckpt_dir)
        if last is not None:
            def shapes(ps, stacked):
                return torch.empty(((len(ps),) if stacked else ())
                                   + tuple(ps[0].shape), device="meta")

            def moment_shapes(ps, stacked):
                return {k: shapes([v] * len(ps), stacked)
                        for k, v in opt.moments(ps[0]).items()}

            example = {"params": reference_tree(model, shapes),
                       "opt": {"step": torch.empty((), device="meta"),
                               "mu": reference_tree(model, moment_shapes)}}
            if mesh is None:
                # restored in host memory, then copied into the model
                state = restore_checkpoint(ckpt_dir, last, example,
                                           device="cpu")
            else:  # laid out as the model and its moments, on any mesh
                axes = model.param_axes()
                state = restore_checkpoint(
                    ckpt_dir, last, example, device=dev,
                    shardings=shardings_from_axes(
                        mesh, example, {"params": axes,
                                        "opt": opt.state_axes(axes)}))
            load_reference_params(model, state["params"])
            from_reference_opt_state(model, opt, state["opt"])
            start = last
            if lead:
                print(f"[train] resumed from step {last}", flush=True)

    step_fn = train_step_fn(cfg, opt)

    # preemption: finish the step, checkpoint, exit 42
    preempted = threading.Event()

    def _sig(_s, _f):
        print("[train] preemption signal received", flush=True)
        preempted.set()

    old_term = signal.signal(signal.SIGTERM, _sig)
    old_int = signal.signal(signal.SIGINT, _sig)

    wd = StepWatchdog()
    it = make_train_iterator(cfg.vocab, seq, batch, seed=seed, start_step=start)
    losses = []
    log_path = (pathlib.Path(ckpt_dir) / "metrics.jsonl"
                if ckpt_dir and lead else None)
    try:
        for step, hostbatch in it:
            if step >= steps:
                break
            t0 = time.time()
            # this data rank's rows of the global batch
            b = {k: torch.from_numpy(v[rows]).to(dev)
                 for k, v in hostbatch.items()}
            metrics = step_fn(model, b)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            wd.observe(dt)
            losses.append(loss)
            if on_step:
                on_step(step, loss)
            if step % log_every == 0 and lead:
                print(f"[train] step {step:5d} loss {loss:.4f} ({dt:.3f}s)", flush=True)
                if log_path:
                    with log_path.open("a") as f:
                        f.write(json.dumps({"step": step, "loss": loss, "dt": dt}) + "\n")
            if ckpt and (step + 1) % ckpt_every == 0:
                ckpt.save(step + 1, _state(model, opt))
            if _any_rank(preempted.is_set(), dev):
                if ckpt:
                    ckpt.save(step + 1, _state(model, opt))
                    ckpt.wait()
                if lead:
                    print(f"[train] checkpointed at step {step + 1}, "
                          f"exiting for restart", flush=True)
                return {"final_loss": losses[-1], "first_loss": losses[0],
                        "steps_done": step + 1, "preempted": True,
                        "losses": losses}
        if ckpt:
            ckpt.save(min(steps, start + len(losses)) if losses else steps,
                      _state(model, opt))
            ckpt.wait()
    finally:
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)
    return {
        "final_loss": losses[-1] if losses else float("nan"),
        "first_loss": losses[0] if losses else float("nan"),
        "steps_done": start + len(losses),
        "preempted": False,
        "losses": losses,
        "straggler_warnings": wd.warnings,
        "params": model,
        "optimizer": opt,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--full", action="store_true", help="full config (not smoke)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    out = train(args.arch, smoke=not args.full, steps=args.steps,
                batch=args.batch, seq=args.seq, lr=args.lr,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                device=args.device)
    print(f"[train] done: first={out['first_loss']:.4f} final={out['final_loss']:.4f}")
    if out.get("preempted"):
        sys.exit(42)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Training-path probe of the port on one NVIDIA card: llama3.2-1b at its
full published config, batch 8 x 256 (the reference CLI's default), the
reference's AdamW at lr 1e-3, remat "full":

1. median step seconds, tokens/s and peak memory over ``--steps`` steps
   after two warm-up steps, in three numeric modes: fp32 with TF32 off (the
   reference's ``train``), fp32 with TF32 matmuls, and bf16 parameters and
   compute (the optimizer's moments stay fp32);
2. where an fp32 step's time goes: the forward and backward pass against
   the optimizer step (host clock, synchronised), and under
   ``torch.profiler`` the device's busy share and its largest kernels;
3. a full-width checkpoint of the fp32 training state (parameters and
   both moments, the reference's layout): seconds to convert it to host
   arrays, seconds ``AsyncCheckpointer.save`` holds the caller (its host
   copy), seconds of the background write, bytes on disk, and seconds to
   restore it into the model and optimizer.  Skipped, and said so, when
   the disk holding ``--dir`` has less than three times the state free.

    python3 scripts/train_probe.py [--steps 5] [--dir build/train_probe]

Prints one JSON line per measurement and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.ckpt import AsyncCheckpointer, restore_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticTextDataset  # noqa: E402
from repro_torch.models import init_params, train_step_fn  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    from_reference_opt_state,
    load_reference_params,
    to_reference_opt_state,
    to_reference_params,
)
from repro_torch.optim import AdamW  # noqa: E402

from lm_breakdown import profiled  # noqa: E402  (this script's directory)

B, S, LR = 8, 256, 1e-3


def step_times(dtype, tf32: bool, steps: int) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    cfg = dataclasses.replace(get_config("llama3.2-1b"), param_dtype=dtype,
                              compute_dtype=dtype)
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, 0, device="cuda")
    opt = AdamW(model.param_groups(), lr=LR)
    step = train_step_fn(cfg, opt)
    ds = SyntheticTextDataset(cfg.vocab, S, B, seed=0)
    secs, losses = [], []
    for i in range(steps + 2):
        b = {k: torch.from_numpy(v).cuda() for k, v in ds.batch_at(i).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(step(model, b)["loss"])
        secs.append(time.perf_counter() - t0)
        losses.append(loss)
    med = float(np.median(secs[2:]))
    rec = {"mode": f"{str(dtype).split('.')[-1]}{' tf32' if tf32 else ''}",
           "median_step_s": med, "tok_s": B * S / med, "step_s": secs,
           "losses": losses,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if not all(np.isfinite(losses)):
        raise AssertionError(f"nonfinite loss: {rec}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return rec, model, opt


def breakdown(model, opt) -> dict:
    """One more fp32 step split into its two halves, then one profiled."""
    cfg = model.cfg
    b = SyntheticTextDataset(cfg.vocab, S, B, seed=0).batch_at(99)
    b = {k: torch.from_numpy(v).cuda() for k, v in b.items()}
    model.requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.zero_grad(set_to_none=True)
    loss, _ = model.loss(b["tokens"], b["labels"])
    loss.backward()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    opt.step()
    torch.cuda.synchronize()
    rec = {"fwd_bwd_s": t1 - t0, "optimizer_s": time.perf_counter() - t1}
    step = train_step_fn(cfg, opt)
    rec.update(profiled(lambda: float(step(model, b)["loss"])))
    return rec


def checkpoint_times(model, opt, where: Path) -> dict:
    nbytes = sum(p.numel() * 4 * 3 for p in model.parameters())
    free = shutil.disk_usage(where.parent).free
    rec = {"state_gb": nbytes / 1e9, "free_gb": free / 1e9}
    if free < 3 * nbytes:
        rec["skipped"] = "not measured: too little free disk"
        return rec
    t0 = time.perf_counter()
    tree = {"params": to_reference_params(model),
            "opt": to_reference_opt_state(model, opt)}
    rec["to_host_s"] = time.perf_counter() - t0
    ck = AsyncCheckpointer(where, keep_last=1)
    t0 = time.perf_counter()
    ck.save(1, tree)
    rec["save_call_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ck.wait()
    rec["background_write_s"] = time.perf_counter() - t0
    rec["disk_gb"] = sum(f.stat().st_size for f in where.rglob("*")
                         if f.is_file()) / 1e9
    t0 = time.perf_counter()
    back = restore_checkpoint(where, 1, tree, device="cpu")
    del tree
    load_reference_params(model, back["params"])
    from_reference_opt_state(model, opt, back["opt"])
    torch.cuda.synchronize()
    rec["restore_s"] = time.perf_counter() - t0
    shutil.rmtree(where, ignore_errors=True)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--dir", default=str(ROOT / "build" / "train_probe"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_probe: no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for dtype, tf32 in ((torch.bfloat16, False), (torch.float32, True),
                        (torch.float32, False)):
        rec, model, opt = step_times(dtype, tf32, args.steps)
        print(json.dumps(rec), flush=True)
        if dtype is torch.float32 and not tf32:
            print(json.dumps({"breakdown": breakdown(model, opt)}),
                  flush=True)
            print(json.dumps({"checkpoint": checkpoint_times(
                model, opt, Path(args.dir))}), flush=True)
        del model, opt
        torch.cuda.empty_cache()
    print(smi)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Where the LM stack's serving steps spend their time on the card:

    python3 scripts/lm_breakdown.py [arch ...]   (default llama3.2-1b mamba2-1.3b)

For each arch at its full published config (bf16, weights from a seeded
generator on the card): a prefill of 4 prompts of 512 tokens and 8 greedy
decode steps, each once warm and untimed, then once under
``torch.profiler``: wall seconds, the device's busy time (the sum of the
kernels' and copies' device time; the tracer adds its own host overhead to
the wall time) and share, kernel launches, and the device time by kernel
name.  Then the same decode steps again without the profiler, timed by the
host clock, for the per-step seconds the profiler does not inflate.

Prints one JSON object per arch, then the card's name and power limit.
Needs a CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import init_cache, init_params  # noqa: E402

B, P, T = 4, 512, 8


def _device_us(ev) -> float:
    return getattr(ev, "self_device_time_total",
                   getattr(ev, "self_cuda_time_total", 0.0))


def profiled(fn) -> dict:
    """Wall seconds, device busy seconds and share, launches and the top
    kernels of one call of ``fn`` under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # the tracer's own start-up, not timed
        torch.ones(1, device="cuda").sum().item()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = [(ev.key, _device_us(ev) / 1e3, ev.count)
            for ev in prof.key_averages()
            if _device_us(ev) > 0 and not ev.key.startswith("aten::")
            and ev.key != "Activity Buffer Request"]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e3
    return {"wall_s": wall, "device_busy_s": busy,
            "device_busy_share": busy / wall,
            "launches": sum(r[2] for r in rows),
            "top": [{"name": k[:80], "ms": ms, "count": c}
                    for k, ms, c in rows[:8]]}


def breakdown(arch: str) -> dict:
    cfg = get_config(arch)
    model = init_params(cfg, 0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen,
                           device="cuda", dtype=torch.int32)
    state = {}

    def prefill():
        state["caches"] = init_cache(cfg, B, P + T, device="cuda")
        state["logits"], state["caches"] = model.prefill(prompt,
                                                         state["caches"])

    def decode():
        for t in range(T):
            tok = torch.argmax(state["logits"], -1)[:, None].to(torch.int32)
            state["logits"], state["caches"] = model.decode_step(
                tok, state["caches"], P + t)

    prefill()
    decode()                                  # warm
    out = {"arch": arch, "batch": B, "prompt": P, "decode_steps": T,
           "prefill": profiled(prefill)}
    out["decode"] = profiled(decode)
    out["decode"]["launches_per_step"] = out["decode"]["launches"] / T
    prefill()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode()
    torch.cuda.synchronize()
    out["decode_step_s_unprofiled"] = (time.perf_counter() - t0) / T
    return out


def main(argv) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("lm_breakdown: needs a CUDA card")
    for arch in argv or ["llama3.2-1b", "mamba2-1.3b"]:
        print(json.dumps(breakdown(arch)), flush=True)
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main(sys.argv[1:])

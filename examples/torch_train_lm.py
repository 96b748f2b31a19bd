"""End-to-end training example on the port (``repro_torch``): train a
llama-family model on the synthetic stream with checkpointing, then serve
a few greedy generations from the trained weights with the model's own
``prefill`` / ``decode_step``.

The default invocation trains the reduced (smoke) llama3.2-1b config;
pass --big to use a ~100M-param config (same code path).  It runs on the
card unless --device cpu is given.

    PYTHONPATH=src python examples/torch_train_lm.py [--big] [--steps 200] \\
        [--device cpu]
"""
import argparse
import dataclasses
import tempfile
import time

import numpy as np
import torch

import repro_torch.configs.llama3_2_1b as llama_mod
from repro_torch.configs import get_smoke_config
from repro_torch.launch.train import train
from repro_torch.models import init_cache

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=200)
ap.add_argument("--big", action="store_true", help="~100M-param config")
ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
args = ap.parse_args()

if args.big:
    # ~100M params: 8L, d=512, 8 heads, vocab 32k
    cfg100m = dataclasses.replace(
        get_smoke_config("llama3.2-1b"),
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=2048, vocab=32_000)
    llama_mod.SMOKE = cfg100m  # train() resolves the smoke config by name
    print(f"config: {cfg100m.n_params() / 1e6:.0f}M params")

with tempfile.TemporaryDirectory() as ckpt_dir:
    out = train("llama3.2-1b", smoke=True, steps=args.steps, batch=8,
                seq=256, lr=1e-3, ckpt_dir=ckpt_dir, ckpt_every=50,
                device=args.device)
print(f"loss: {out['first_loss']:.3f} -> {out['final_loss']:.3f} "
      f"over {out['steps_done']} steps")
if not out["final_loss"] < out["first_loss"]:
    raise SystemExit("model failed to learn")

# greedy generations from the trained weights: 4 prompts of 16 tokens,
# prefilled together, then 16 decode steps
model = out["params"]
cfg, dev = model.cfg, model.device
B, P, T = 4, 16, 16
rng = np.random.default_rng(0)
prompts = torch.from_numpy(
    rng.integers(0, cfg.vocab, (B, P)).astype(np.int32)).to(dev)
caches = init_cache(cfg, B, P + T, cfg.compute_dtype, device=dev)
t0 = time.perf_counter()
logits, caches = model.prefill(prompts, caches)
fed = []
for t in range(T):
    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    fed.append(tok)
    logits, caches = model.decode_step(tok, caches, P + t)
gen = torch.cat(fed, dim=1).cpu().numpy()
secs = time.perf_counter() - t0
print(f"served {B * T} tokens at {B * T / secs:.1f} tok/s "
      f"in {T} batched decode steps")
print("sample generation:", gen[0].tolist())

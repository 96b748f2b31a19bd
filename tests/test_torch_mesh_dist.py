"""The LM stack on a device mesh, in four spawned gloo ranks on the CPU.

One module fixture starts the four ranks once per test run (this file
run as a script, one intra-op thread each, a file ``init_method`` in the
run's temporary directory; under pytest-xdist one worker starts them and
the others read the result); they run every collective case and rank
0 writes the results as JSON.  The tests
then assert on them:

  * ``moe_forward_local`` at (2, 2) and (1, 4) against the global path in
    one process, on the reference's test shape (d 32, 8 experts, top 2,
    capacity 64, so nothing is dropped): output < 1e-4 absolute and within
    1e-5 of its largest, gradients of x, router, experts (and shared
    experts) within 1e-5 of each leaf's largest, aux within 0.05 (the
    local path averages each data shard's statistic);
  * the global path in the dropping regime (capacity 1.0) on a batch split
    over the data axes equals the one-process result;
  * ``train`` at (2, 2) against (1, 1) (one process, no group) for the
    smoke llama and dbrx with the global dispatch, and at (1, 4) for both:
    losses within 1e-5 relative over 5 steps; dbrx with the local dispatch
    at (1, 4) within 1e-5 too; parameters and moments carry the plan's
    placements;
  * tensor-parallel compute over "model" against one process, one loss
    and its backward pass on the same batch: the smoke llama at (1, 4)
    and (2, 2), dbrx (global dispatch) at (1, 4), mamba2 at (1, 4) (the
    gated norm's sum over the model ranks), deepseek at (2, 2) (MLA, the
    vocab-parallel loss, MTP): loss, cross entropy and the final hidden
    state within 1e-5 relative, each gradient leaf within 1e-5 of its
    largest magnitude, and the forward pass's sums over "model" at least
    two a layer; llama with 6 heads over 4 model ranks (2, 2, 2, 0 heads:
    their columns gathered, since the even storage split cuts heads); llama
    under ``gather_bf16`` at (1, 4) takes the
    replicated path: its hidden state equals one process's bit for bit,
    with the embedding's one sum over "model" and none in its layers;
  * prefill then two decode steps at (1, 4) under ``decode_32k``'s rule
    (the caches' positions split over "model") through the cells'
    steps, for the smoke llama, deepseek and mamba2, against one process:
    logits within 1e-5 of their largest;
  * dbrx with the local dispatch at (2, 2), nothing dropped, against one
    process: the first step's cross entropy within 1e-5;
  * AdamW with the int8 second moment on a (2, 2) mesh against one
    process: its per-row scales are the whole rows' maxima;
  * a checkpoint written at (2, 2) restores at (4, 1) bit for bit with the
    asked placements, and resuming there gives the uninterrupted run's
    losses within 1e-6 relative; the same files restore in one process
    and in ``repro.ckpt``.

The local dispatch with more than one data rank pools capacity and the aux
statistic per data shard, by design (the reference's ``moe.py:131-242``):
its aux is held to the mean over the data shards of the one-process aux of
each shard's rows (1e-6), and its training run only at the first step,
before the two aux estimators' gradients have moved the weights apart.
"""
import fcntl
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 120.0
B, S, STEPS = 4, 32, 5
MOE_TOL = 1e-5
#: tensor-parallel cases: (arch, mesh shape, config fields); 6 heads
#: over 4 model ranks split as GSPMD pads them (2, 2, 2, 0), their wq
#: columns cut mid-head by the even storage split
TP_CASES = (("llama3.2-1b", (1, 4), {}), ("llama3.2-1b", (2, 2), {}),
            ("dbrx-132b", (1, 4), {}), ("mamba2-1.3b", (1, 4), {}),
            ("deepseek-v3-671b", (2, 2), {}),
            ("llama3.2-1b", (1, 4), {"n_heads": 6, "n_kv_heads": 2}),
            ("llama3.2-1b", (1, 4), {"gather_bf16": True}))


def _tp_name(arch, shape, kw) -> str:
    return " ".join([arch, str(shape)] + [f"{k}={v}" for k, v in kw.items()])

SERVE_ARCHS = ("llama3.2-1b", "deepseek-v3-671b", "mamba2-1.3b")
TP_TOL = 1e-5


# ---------------------------------------------------------------------------
# the ranks' side (run as a script)
# ---------------------------------------------------------------------------
def _moe_cfg(**kw):
    from repro_torch.models.common import ModelConfig
    return ModelConfig(d_model=32, moe_experts=8, moe_top_k=2, moe_d_ff=16,
                       param_dtype=torch.float32, compute_dtype=torch.float32,
                       **kw)


def _rel(a: torch.Tensor, want: torch.Tensor) -> float:
    return float((a - want).abs().max() / want.abs().max())


def _moe_case(mesh, cfg) -> dict:
    """``moe_forward`` on ``mesh`` (x split over the data axes, weights laid
    out by ``moe_axes``) against the global path in one process; the loss
    is the sum of the squared outputs."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.steps import shardings_from_axes
    from repro_torch.models.common import (data_rank, data_size,
                                           set_active_mesh, whole)
    from repro_torch.models.moe import (EXPERT_WEIGHTS, _moe_forward_global,
                                        moe_axes, moe_forward, moe_params)

    p = moe_params(cfg, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 16, 32)).astype(np.float32))
    set_active_mesh(None)
    pg = {k: v.clone().requires_grad_() for k, v in p.items()}
    xg = x.clone().requires_grad_()
    out_g, aux_g = _moe_forward_global(cfg, pg, xg)
    (out_g ** 2).sum().backward()
    n = data_size(mesh)
    with torch.no_grad():   # each data shard's aux, in one process
        aux_shards = sum(float(_moe_forward_global(cfg, p, xs)[1])
                         for xs in x.chunk(n)) / n

    set_active_mesh(mesh)
    try:
        plan = shardings_from_axes(mesh, p, moe_axes(cfg))
        pd = {k: distribute_tensor(v.clone(), mesh, plan[k],
                                   src_data_rank=None).requires_grad_()
              for k, v in p.items()}
        r = data_rank(mesh)
        rows = slice(r * 4 // n, (r + 1) * 4 // n)
        xl = x[rows].clone().requires_grad_()
        call = {k: v if k in EXPERT_WEIGHTS else whole(v)
                for k, v in pd.items()}
        out, aux = moe_forward(cfg, call, xl)
        (out ** 2).sum().backward()
    finally:
        set_active_mesh(None)
    want = out_g.detach()[rows]
    rec = {"out_abs": float((out.detach() - want).abs().max()),
           "out_rel": float((out.detach() - want).abs().max()
                            / out_g.detach().abs().max()),
           "aux": abs(float(aux) - float(aux_g)),
           "aux_shards": abs(float(aux) - aux_shards),
           "grad": {"x": _rel(xl.grad, xg.grad[rows])}}
    for k, v in pd.items():
        rec["grad"][k] = _rel(v.grad.full_tensor(), pg[k].grad)
    return rec


def _placements_bad(model, opt, mesh) -> list:
    """Parameters and moments whose placements differ from the plan:
    ``shardings_from_axes`` over the reference's stacked trees, less the
    stacked leaves' leading layer axis."""
    from torch.distributed.tensor import Shard

    from repro_torch.launch.steps import shardings_from_axes
    from repro_torch.models.convert import _entries, reference_tree

    def meta(ps, stacked):
        return torch.empty(((len(ps),) if stacked else ())
                           + tuple(ps[0].shape), device="meta")

    def moments(ps, stacked):
        return {k: meta([v] * len(ps), stacked)
                for k, v in opt.moments(ps[0]).items()}

    axes = model.param_axes()
    plan = shardings_from_axes(mesh, reference_tree(model, meta), axes)
    mu = shardings_from_axes(mesh, {"step": meta([torch.empty(())], False),
                                    "mu": reference_tree(model, moments)},
                             opt.state_axes(axes))["mu"]

    def at(tree, path, stacked):
        for k in path:
            tree = tree[k]
        return tuple(Shard(p.dim - stacked) if isinstance(p, Shard) else p
                     for p in tree)

    bad = []
    for path, ps, stacked in _entries(model):
        for p in ps:
            if tuple(p.placements) != at(plan, path, stacked):
                bad.append(f"{path}: {p.placements}")
            for k, m in opt.moments(p).items():
                if tuple(m.placements) != at(mu, path + (k,), stacked):
                    bad.append(f"{path} {k}: {m.placements}")
    return bad


def _train_case(arch, shape, **cfg_kw) -> dict:
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train

    mod = registry._module(arch)
    smoke = mod.SMOKE
    mod.SMOKE = dataclasses.replace(smoke, **cfg_kw)
    try:
        out = train(arch, steps=STEPS, batch=B, seq=S, device="cpu",
                    mesh_shape=shape)
    finally:
        mod.SMOKE = smoke
    return {"losses": out["losses"], "placements_bad": _placements_bad(
        out["params"], out["optimizer"], make_host_mesh(shape, device="cpu"))}


def _local_2x2_case() -> dict:
    """The smoke dbrx with the local dispatch and nothing dropped, 5
    ``train_step_fn`` steps on a (2, 2) mesh and in one process from the
    same weights and batches: each step's ce and aux, and the mesh run's
    placements."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.data import make_train_iterator
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import place_model
    from repro_torch.models import init_params, set_active_mesh, train_step_fn
    from repro_torch.models.common import data_rank
    from repro_torch.optim import AdamW, cosine_schedule

    cfg = dataclasses.replace(get_smoke_config("dbrx-132b"),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32,
                              moe_impl="local", capacity_factor=64.0)
    mesh = make_host_mesh((2, 2), device="cpu")
    r = data_rank(mesh)
    out = {}
    for name, m in (("one", None), ("mesh", mesh)):
        model = init_params(cfg, 0, device="cpu")
        if m is not None:
            place_model(model, m)
        opt = AdamW(model.param_groups(),
                    lr=cosine_schedule(3e-4, warmup=1, total=STEPS))
        step = train_step_fn(cfg, opt)
        it = make_train_iterator(cfg.vocab, S, B)
        rec = out[name] = {"ce": [], "aux": []}
        set_active_mesh(m)
        try:
            for _ in range(STEPS):
                _, hb = next(it)
                rows = slice(None) if m is None else slice(r * B // 2,
                                                           (r + 1) * B // 2)
                met = step(model, {k: torch.from_numpy(v[rows])
                                   for k, v in hb.items()})
                rec["ce"].append(float(met["ce"]))
                rec["aux"].append(float(met["aux"]))
        finally:
            set_active_mesh(None)
    out["placements_bad"] = _placements_bad(model, opt, mesh)
    return out


def _quantize_v_case() -> dict:
    """Two AdamW(quantize_v) steps of the smoke llama on a (2, 2) mesh
    against one process: ``m``, the codes ``vq`` and the scales ``vs``."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import place_model
    from repro_torch.models import init_params, set_active_mesh, train_step_fn
    from repro_torch.models.common import data_rank
    from repro_torch.optim import AdamW

    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(
        np.int32)) for k in ("tokens", "labels")}
    one = init_params(cfg, 0, device="cpu")
    opt1 = AdamW(one.param_groups(), lr=1e-3, quantize_v=True)
    for _ in range(2):
        train_step_fn(cfg, opt1)(one, batch)

    mesh = make_host_mesh((2, 2), device="cpu")
    model = init_params(cfg, 0, device="cpu")
    place_model(model, mesh)
    opt = AdamW(model.param_groups(), lr=1e-3, quantize_v=True)
    r = data_rank(mesh)
    local = {k: v[r * B // 2:(r + 1) * B // 2] for k, v in batch.items()}
    set_active_mesh(mesh)
    try:
        for _ in range(2):
            train_step_fn(cfg, opt)(model, local)
    finally:
        set_active_mesh(None)
    rec = {"m": 0.0, "vs": 0.0, "vq_off_by": 0,
           "placements_bad": _placements_bad(model, opt, mesh)}
    for p, q in zip(model.parameters(), one.parameters()):
        st, st1 = opt.moments(p), opt1.moments(q)
        rec["m"] = max(rec["m"], _rel(st["m"].full_tensor(), st1["m"]))
        rec["vs"] = max(rec["vs"], _rel(st["vs"].full_tensor(), st1["vs"]))
        rec["vq_off_by"] = max(rec["vq_off_by"], int(
            (st["vq"].full_tensor().int() - st1["vq"].int()).abs().max()))
    return rec


def _elastic_case(tmp: Path) -> dict:
    """The smoke llama at (2, 2): uninterrupted for 6 steps, and preempted
    after step 2 into a checkpoint; that checkpoint restored at (4, 1) with
    the plan's placements, then resumed there to step 6."""
    import dataclasses

    from repro_torch.ckpt import latest_step, restore_checkpoint
    from repro_torch.ckpt.checkpoint import _leaves, _paired
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import place_model, shardings_from_axes
    from repro_torch.launch.train import train
    from repro_torch.models import init_params
    from repro_torch.models.convert import reference_tree
    from repro_torch.optim import AdamW

    kw = dict(steps=6, batch=B, seq=S, device="cpu", ckpt_every=100)
    whole = train("llama3.2-1b", mesh_shape=(2, 2), **kw)["losses"]

    def stop(step, loss):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    ck = tmp / "ckpt"
    first = train("llama3.2-1b", mesh_shape=(2, 2), ckpt_dir=str(ck),
                  on_step=stop, **kw)
    # restore at (4, 1), laid out as a model and its moments there
    mesh = make_host_mesh((4, 1), device="cpu")
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    model = init_params(cfg, 0, device="cpu")
    place_model(model, mesh)
    opt = AdamW(model.param_groups())

    def meta(ps, stacked):
        return torch.empty(((len(ps),) if stacked else ())
                           + tuple(ps[0].shape), device="meta")

    example = {"params": reference_tree(model, meta),
               "opt": {"step": torch.empty((), device="meta"),
                       "mu": reference_tree(model, lambda ps, st: {
                           k: meta([v] * len(ps), st)
                           for k, v in opt.moments(ps[0]).items()})}}
    axes = model.param_axes()
    plan = shardings_from_axes(mesh, example, {"params": axes,
                                               "opt": opt.state_axes(axes)})
    got = restore_checkpoint(ck, 3, example, device="cpu",
                             shardings=_on(mesh, plan))
    with np.load(ck / "step_000000003" / "arrays.npz") as data:
        arrays = [data[f"leaf_{i}"] for i in range(len(data.files))]
    leaves = list(_leaves(got))
    pls = list(_paired(example, plan))
    rec = {"bit_equal": len(leaves) == len(arrays) and all(
               np.array_equal(t.full_tensor().numpy(), a)
               for t, a in zip(leaves, arrays)),
           "placements_equal": all(tuple(t.placements) == tuple(pl)
                                   for t, pl in zip(leaves, pls)),
           "n_leaves": len(leaves)}
    resumed = train("llama3.2-1b", mesh_shape=(4, 1), ckpt_dir=str(ck),
                    **kw)
    rec.update(whole=whole, first=first["losses"],
               preempted=first["preempted"], resumed=resumed["losses"],
               latest=latest_step(ck))
    return rec


def _on(mesh, plan):
    """``plan``'s placements as ``(mesh, placements)`` leaves."""
    if isinstance(plan, dict):
        return {k: _on(mesh, v) for k, v in plan.items()}
    if isinstance(plan, list):
        return [_on(mesh, v) for v in plan]
    return (mesh, plan)


def _tp_case(arch, shape, **cfg_kw) -> dict:
    """One loss of the smoke ``arch`` (fp32) and its backward pass on a
    ``shape`` mesh against one process, on the same batch: the relative
    errors of loss, cross entropy and final hidden state, the worst
    gradient leaf's error relative to its largest magnitude, and the
    forward pass's sums over "model"."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import place_model
    from repro_torch.models import common, init_params, set_active_mesh
    from repro_torch.models.common import data_rank, data_size, mean_data

    cfg = dataclasses.replace(get_smoke_config(arch),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32, **cfg_kw)
    rng = np.random.default_rng(3)
    tok, lab = (torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
                for _ in range(2))
    set_active_mesh(None)
    one = init_params(cfg, 0, device="cpu")
    one.requires_grad_(True)
    loss1, met1 = one.loss(tok, lab)
    loss1.backward()
    with torch.no_grad():
        h1 = one.forward(tok)[0]
    mesh = make_host_mesh(shape, device="cpu")
    model = init_params(cfg, 0, device="cpu")
    place_model(model, mesh)
    n, r = data_size(mesh), data_rank(mesh)
    rows = slice(r * B // n, (r + 1) * B // n)
    sums, plain = [], common._sum_over

    def counted(x, mesh, axes, *a):
        sums.append(tuple(axes))
        return plain(x, mesh, axes, *a)

    set_active_mesh(mesh)
    try:
        model.requires_grad_(True)
        loss, met = model.loss(tok[rows], lab[rows])
        (loss / n).backward()
        common._sum_over = counted
        with torch.no_grad():
            h = model.forward(tok[rows])[0]
        loss, ce = (float(mean_data(v.detach(), mesh))
                    for v in (loss, met["ce"]))
    finally:
        common._sum_over = plain
        set_active_mesh(None)
    grad = {name: _rel(p.grad.full_tensor(), q.grad) for (name, p), q in
            zip(model.named_parameters(), one.parameters())}
    return {"loss": abs(loss - float(loss1)) / abs(float(loss1)),
            "ce": abs(ce - float(met1["ce"])) / abs(float(met1["ce"])),
            "h": _rel(h, h1[rows]), "h_equal": torch.equal(h, h1[rows]),
            "grad": max(grad.values()), "worst": max(grad, key=grad.get),
            "model_sums": sums.count(("model",)), "n_layers": cfg.n_layers}


def _serve_case(arch, shape, T: int = 64, batch: int = 4) -> dict:
    """Prefill of T tokens, then decode steps at lengths T / 2 + 3 and
    T - 1, through the prefill and decode cells' steps under
    ``decode_32k``'s rules (positions over "model"), on a ``shape`` mesh
    and in one process: each step's logits' error relative to their
    largest."""
    import repro_torch.configs.registry as preg
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import set_active_mesh, set_mesh_rules
    from repro_torch.models.common import data_rank, data_size

    shapes = dict(preg.SHAPES)
    for k in ("prefill_32k", "decode_32k"):
        shapes[k] = preg.ShapeSpec(k, T, batch, preg.SHAPES[k].kind)
    saved = steps.SHAPES
    steps.SHAPES = shapes
    rules = steps.SHAPE_RULES["decode_32k"]
    over = {"param_dtype": torch.float32, "compute_dtype": torch.float32}
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, 512, (batch, T + 2)).astype(
        np.int32))
    got = {}
    try:
        for name, m in (("one", None),
                        ("mesh", make_host_mesh(shape, device="cpu"))):
            pre = steps.build_cell(arch, "prefill_32k", m, smoke=True,
                                   rules=rules, overrides=over)
            model, b, caches = pre.make_args("cpu",
                                             batch={"tokens": toks[:, :T]})
            logits, caches = pre.step(model, b, caches)
            dec = steps.build_cell(arch, "decode_32k", m, smoke=True,
                                   rules=rules, overrides=over)
            got[name] = [logits]
            for i, clen in enumerate((T // 2 + 3, T - 1)):
                tok = steps.layout(m, {"tokens": toks[:, T + i:T + i + 1]},
                                   dec.in_shardings[0])
                cl = steps.layout(m, torch.tensor(clen, dtype=torch.int32),
                                  dec.in_shardings[2])
                logits, caches = dec.step(model, tok, caches, cl)
                got[name].append(logits)
            set_active_mesh(None)
            set_mesh_rules({})
    finally:
        steps.SHAPES = saved
    n, r = data_size(m), data_rank(m)
    rows = slice(r * batch // n, (r + 1) * batch // n)
    return {"logits": [_rel(a, b[rows])
                       for a, b in zip(got["mesh"], got["one"])]}


def _rank_main(rank: int, out: Path) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out / 'init'}",
                            rank=rank, world_size=WORLD)
    res = {"moe": {}}
    try:
        for shape in ((2, 2), (1, 4)):
            mesh = make_host_mesh(shape, device="cpu")
            for name, kw in (("plain", {}), ("shared", {
                    "moe_shared_experts": 1})):
                res["moe"][f"{shape}-{name}"] = _moe_case(
                    mesh, _moe_cfg(capacity_factor=64.0, moe_impl="local",
                                   **kw))
        res["dropping"] = _moe_case(make_host_mesh((2, 2), device="cpu"),
                                    _moe_cfg(capacity_factor=1.0))
        res["train"] = {
            "llama": _train_case("llama3.2-1b", (2, 2)),
            "llama-1x4": _train_case("llama3.2-1b", (1, 4)),
            "dbrx-global": _train_case("dbrx-132b", (2, 2)),
            "dbrx-global-1x4": _train_case("dbrx-132b", (1, 4)),
            "dbrx-local-1x4": _train_case("dbrx-132b", (1, 4),
                                          moe_impl="local"),
        }
        res["tp"] = {_tp_name(*case): _tp_case(case[0], case[1], **case[2])
                     for case in TP_CASES}
        res["serve"] = {arch: _serve_case(arch, (1, 4))
                        for arch in SERVE_ARCHS}
        res["local_2x2"] = _local_2x2_case()
        res["quantize_v"] = _quantize_v_case()
        res["elastic"] = _elastic_case(out)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        (out / "result.json").write_text(json.dumps(res))


# ---------------------------------------------------------------------------
# the test process's side
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks' results.  Under pytest-xdist each worker that runs a test
    of this module sets the fixture up; the first to take the lock in the
    run's shared temporary directory starts the ranks and the others read
    what they wrote."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent  # the run's directory, above each worker's
    out = base / "torch_mesh_dist"
    out.mkdir(exist_ok=True)
    with open(out / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if (out / "failed.txt").exists():
                pytest.fail((out / "failed.txt").read_text())
            if not (out / "result.json").exists():
                try:
                    _start_ranks(out)
                except BaseException as e:
                    (out / "failed.txt").write_text(str(e))
                    raise
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    res = json.loads((out / "result.json").read_text())
    res["dir"] = str(out)
    return res


def _start_ranks(out: Path) -> None:
    """Run the ranks (this file as a script), killing them and failing
    after ``TIMEOUT`` seconds."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(WORLD):
        log = open(out / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(r), str(out)], env=env,
            stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            p.kill()
            p.wait()
        for log in logs:
            log.close()
    tails = "\n".join(f"--- rank {r}\n" + (out / f"rank{r}.log").read_text()[
        -3000:] for r in range(WORLD))
    if hung:
        pytest.fail(f"{len(hung)} ranks still running after {TIMEOUT} s\n"
                    f"{tails}")
    if any(p.returncode for p in procs):
        pytest.fail(f"ranks exited {[p.returncode for p in procs]}\n{tails}")


@pytest.fixture(scope="module")
def single():
    """(1, 1) runs in this process (no group): the smoke llama and dbrx."""
    from repro_torch.launch.train import train

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        kw = dict(steps=STEPS, batch=B, seq=S, device="cpu")
        return {"llama": train("llama3.2-1b", **kw)["losses"],
                "dbrx": train("dbrx-132b", **kw)["losses"]}
    finally:
        torch.set_num_threads(n)


def _max_rel(got, want) -> float:
    assert len(got) == len(want)
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


@pytest.mark.parametrize("case", ["(2, 2)-plain", "(2, 2)-shared",
                                  "(1, 4)-plain", "(1, 4)-shared"])
def test_local_moe_matches_global(ranks, case):
    r = ranks["moe"][case]
    assert r["out_abs"] < 1e-4 and r["out_rel"] <= MOE_TOL, r
    assert max(r["grad"].values()) <= MOE_TOL, r
    assert set(r["grad"]) >= {"x", "router", "w_gate", "w_up", "w_down"}
    assert r["aux"] < 0.05 and r["aux_shards"] <= 1e-6, r


def test_global_moe_on_a_split_batch_equals_one_process(ranks):
    r = ranks["dropping"]
    assert r["out_abs"] == 0.0 and r["aux"] == 0.0, r
    assert max(r["grad"].values()) <= MOE_TOL, r


@pytest.mark.parametrize("case,ref", [("llama", "llama"),
                                      ("llama-1x4", "llama"),
                                      ("dbrx-global", "dbrx"),
                                      ("dbrx-global-1x4", "dbrx"),
                                      ("dbrx-local-1x4", "dbrx")])
def test_training_on_a_mesh_matches_one_device(ranks, single, case, ref):
    r = ranks["train"][case]
    assert not r["placements_bad"], r["placements_bad"][:5]
    assert _max_rel(r["losses"], single[ref]) <= 1e-5, (r["losses"],
                                                        single[ref])


@pytest.mark.parametrize("case", [_tp_name(*c) for c in TP_CASES])
def test_tensor_parallel_step_matches_one_process(ranks, case):
    r = ranks["tp"][case]
    assert max(r["loss"], r["ce"], r["h"]) <= TP_TOL, r
    assert r["grad"] <= TP_TOL, r
    if case.endswith("gather_bf16=True"):  # the replicated path: only the
        # embedding sums over "model"
        assert r["h_equal"] and r["model_sums"] == 1, r
    else:  # each layer's split compute ends in sums over "model"
        assert r["model_sums"] >= 2 * r["n_layers"] + 1, r


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_decode_over_a_position_split_cache_matches_one_process(ranks,
                                                                arch):
    r = ranks["serve"][arch]
    assert len(r["logits"]) == 3 and max(r["logits"]) <= TP_TOL, r


def test_local_moe_training_with_split_data_first_step(ranks):
    r = ranks["local_2x2"]
    assert not r["placements_bad"], r["placements_bad"][:5]
    one, mesh = r["one"]["ce"][0], r["mesh"]["ce"][0]
    assert abs(mesh - one) <= 1e-5 * abs(one), r


def test_quantized_second_moment_on_a_mesh(ranks):
    r = ranks["quantize_v"]
    assert not r["placements_bad"], r["placements_bad"][:5]
    # a scale of a half row's maximum would be off by a factor: the scales
    # and m hold to the gradients' tolerance (1e-4 of each leaf's largest,
    # as in test_torch_train.py), the codes to one step (parameters: Adam
    # moves an entry whose gradient is near the two runs' rounding by up
    # to lr either way; the training cases hold the losses)
    assert r["vs"] <= 1e-4 and r["m"] <= 1e-4 and r["vq_off_by"] <= 1, r


def test_checkpoint_restores_on_another_mesh(ranks):
    r = ranks["elastic"]
    assert r["preempted"] and r["bit_equal"] and r["placements_equal"], r
    assert r["first"] == r["whole"][:3]
    assert r["latest"] == 6
    assert _max_rel(r["resumed"], r["whole"][3:]) <= 1e-6, r


def test_mesh_checkpoint_restores_in_one_process_and_reference(ranks):
    jax = pytest.importorskip("jax")
    import dataclasses

    import repro.ckpt as ref_ckpt
    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.models.convert import (to_reference_opt_state,
                                            to_reference_params)
    from repro_torch.optim import AdamW

    ck = Path(ranks["dir"]) / "ckpt"
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    model = init_params(cfg, 0, device="cpu")
    example = {"params": to_reference_params(model),
               "opt": to_reference_opt_state(model,
                                             AdamW(model.param_groups()))}
    with np.load(ck / "step_000000003" / "arrays.npz") as data:
        arrays = [data[f"leaf_{i}"] for i in range(len(data.files))]
    port = jax.tree.leaves(restore_checkpoint(ck, 3, example, device="cpu"))
    ref = jax.tree.leaves(ref_ckpt.restore_checkpoint(ck, 3, example))
    assert len(port) == len(ref) == len(arrays) == ranks["elastic"][
        "n_leaves"]
    for a, p, q in zip(arrays, port, ref):
        assert np.array_equal(p.numpy(), a) and np.array_equal(
            np.asarray(q), a)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), Path(sys.argv[2]))

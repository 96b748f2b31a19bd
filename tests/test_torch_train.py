"""The port's training path against the reference on the CPU: gradients of
``LanguageModel.loss`` for every arch's smoke config in fp32 (the
reference's weights carried across) against ``jax.grad`` of the
reference's, each leaf within 1e-4 of its largest magnitude; the three
``remat`` modes equal bit for bit; one ``train_step_fn`` step against the
reference's; a training run resumed from the reference's checkpoint
directory; preemption and resume in the port, and its CLI's exit code.

Adam's first update moves each entry by ``lr * g / (|g| + eps)``, about
``lr`` whatever the size of ``g``, so an entry whose gradient is near the
rounding of the two libraries' gradients (``|g|`` about 1e-7 for a leaf
whose largest is 1e-1) may move differently on the two sides by up to
``2 lr``.  The parameters after a step are held to that, per entry:
``1e-5 max|p| + 2 lr min(1, 1e-4 max|g| / (|g| + eps))``, the second term
carrying the gradient tolerance through the update."""
import dataclasses
import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.ckpt as ref_ckpt  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.launch.train import train as ref_train  # noqa: E402
from repro.models import LanguageModel as RefModel  # noqa: E402
from repro.models.model import train_step_fn as ref_train_step_fn  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.ckpt import latest_step  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import init_params, train_step_fn  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    from_reference_opt_state,
    from_reference_params,
    reference_tree,
    to_reference_opt_state,
    to_reference_params,
)
from repro_torch.optim import AdamW  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GRAD_TOL = 1e-4
B, S = 2, 32


def _fp32(arch):
    r = dataclasses.replace(ref_smoke(arch), param_dtype=jnp.float32,
                            compute_dtype=jnp.float32)
    p = dataclasses.replace(port_configs.get_smoke_config(arch),
                            param_dtype=torch.float32,
                            compute_dtype=torch.float32)
    return r, p


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these smoke-size steps.  In the parallel
    test run several worker processes share the cores, and each small op's
    thread-pool barrier then spins: the 60-step run took 94 s there
    against 3 s alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_init():
    """arch -> the reference's fp32 smoke params, one jitted init each."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg_r, _ = _fp32(arch)
            cache[arch] = jax.jit(RefModel(cfg_r).init)(jax.random.PRNGKey(0))
        return cache[arch]

    return get


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend_tokens:
        out["frontend"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grads(model) -> dict:
    """The port's gradients in the reference's tree layout."""
    return reference_tree(model, lambda ps, stacked: (
        np.stack([p.grad.numpy() for p in ps]) if stacked
        else ps[0].grad.numpy()))


def _worst(got: dict, want: dict) -> tuple[float, str]:
    """Largest |got - want| relative to each leaf's largest |want|."""
    flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    worst = (0.0, "")
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        w = np.asarray(w, np.float64)
        e = float(np.max(np.abs(flat[path] - w))
                  / max(float(np.max(np.abs(w))), 1e-30))
        worst = max(worst, (e, jax.tree_util.keystr(path)))
    return worst


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch, ref_init):
    cfg_r, cfg_p = _fp32(arch)
    params = ref_init(arch)
    batch = _batch(cfg_r)
    (loss_r, _), g_r = jax.jit(jax.value_and_grad(
        lambda p, b: RefModel(cfg_r).loss(p, b["tokens"], b["labels"],
                                          b.get("frontend")),
        has_aux=True))(params, batch)
    model = from_reference_params(cfg_p, jax.tree.map(np.asarray, params),
                                  device="cpu")
    model.requires_grad_(True)
    b = _torch(batch)
    loss, _ = model.loss(b["tokens"], b["labels"], b.get("frontend"))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_r), rtol=1e-5)
    worst, where = _worst(_grads(model), g_r)
    print(f"{arch}: worst gradient leaf {worst:.3g} at {where}")
    assert worst <= GRAD_TOL, (worst, where)


@pytest.mark.parametrize("S", [64, 1024, 1100])
def test_chunked_cross_entropy_gradients_match_reference(S):
    """One chunk, two of 512, two of 550: the value and both gradients."""
    from repro.models.common import chunked_cross_entropy as ref_ce
    from repro_torch.models.common import chunked_cross_entropy

    rng = np.random.default_rng(S)
    h = rng.standard_normal((2, S, 16)).astype(np.float32)
    w = rng.standard_normal((16, 50)).astype(np.float32)
    y = rng.integers(0, 50, (2, S)).astype(np.int32)
    v, (gh, gw) = jax.value_and_grad(lambda h, w: ref_ce(h, w, y),
                                     argnums=(0, 1))(h, w)
    th, tw = (torch.tensor(a, requires_grad=True) for a in (h, w))
    loss = chunked_cross_entropy(th, tw, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(v), rtol=1e-6)
    for got, want in ((th.grad, gh), (tw.grad, gw)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_moe_gradients_with_dropped_tokens_match_reference():
    """Capacity factor 0.5: half the assignments overflow into the dropped
    slot, whose duplicate writes must carry no gradient."""
    from repro.models import moe as ref_moe
    from repro_torch.models import moe

    cfg_r, cfg_p = (dataclasses.replace(c, capacity_factor=0.5)
                    for c in _fp32("dbrx-132b"))
    params = ref_moe.moe_params(cfg_r, jax.random.PRNGKey(3))
    x = np.random.default_rng(4).standard_normal(
        (2, 64, cfg_r.d_model)).astype(np.float32)

    def f(p, x):
        out, aux = ref_moe.moe_forward(cfg_r, p, x)
        return jnp.sum(out * out) + aux

    gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(params, x)
    tp = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    out, aux = moe.moe_forward(cfg_p, tp, tx)
    (torch.sum(out * out) + aux).backward()
    for got, want in [(tp[k].grad, gp[k]) for k in tp] + [(tx.grad, gx)]:
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_give_equal_gradients(arch):
    grads, mms = {}, {}
    for remat in ("none", "full", "dots"):
        _, cfg = _fp32(arch)
        model = init_params(dataclasses.replace(cfg, remat=remat), 0,
                            device="cpu")
        model.requires_grad_(True)
        b = _torch(_batch(cfg))
        loss, _ = model.loss(b["tokens"], b["labels"], b.get("frontend"))
        with _CountMM() as count:
            loss.backward()
        grads[remat] = [p.grad for p in model.parameters()]
        mms[remat] = count.mm
    for remat in ("full", "dots"):
        assert all(torch.equal(a, b) for a, b in
                   zip(grads["none"], grads[remat])), remat
    # "full" recomputes the layers' matmuls in the backward pass, "dots"
    # keeps their outputs
    assert mms["full"] > mms["none"] == mms["dots"]


def test_train_step_matches_reference(ref_init):
    arch, lr = "llama3.2-1b", 1e-3
    cfg_r, cfg_p = _fp32(arch)
    params = ref_init(arch)
    batch = _batch(cfg_r)
    ref_opt = RefAdamW(lr=lr)
    g_r = jax.jit(jax.grad(lambda p: RefModel(cfg_r).loss(
        p, batch["tokens"], batch["labels"])[0]))(params)
    new_r, st_r, met_r = jax.jit(ref_train_step_fn(cfg_r, ref_opt))(
        params, ref_opt.init(params), batch)

    model = from_reference_params(cfg_p, jax.tree.map(np.asarray, params),
                                  device="cpu")
    opt = AdamW(model.param_groups(), lr=lr)
    met = train_step_fn(cfg_p, opt)(model, _torch(batch))
    assert all(met[k].requires_grad is False for k in met)
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(met[k]), float(met_r[k]),
                                   rtol=1e-5, atol=1e-7)
    state = to_reference_opt_state(model, opt)
    assert int(state["step"]) == int(st_r["step"]) == 1
    for k in ("m", "v"):
        worst, where = _worst(
            jax.tree.map(lambda d: d[k], state["mu"],
                         is_leaf=lambda d: isinstance(d, dict) and "m" in d),
            jax.tree.map(lambda d: d[k], st_r["mu"],
                         is_leaf=lambda d: isinstance(d, dict) and "m" in d))
        assert worst <= 1e-4, (k, worst, where)
    got = dict(jax.tree_util.tree_flatten_with_path(
        to_reference_params(model))[0])
    g = dict(jax.tree_util.tree_flatten_with_path(g_r)[0])
    for path, want in jax.tree_util.tree_flatten_with_path(new_r)[0]:
        want, gr = np.asarray(want), np.abs(np.asarray(g[path]))
        bound = (1e-5 * np.max(np.abs(want)) + 2 * lr * np.minimum(
            1.0, GRAD_TOL * np.max(gr) / (gr + ref_opt.eps)))
        assert np.all(np.abs(got[path] - want) <= bound), \
            jax.tree_util.keystr(path)


def test_state_converts_both_ways():
    _, cfg = _fp32("deepseek-v3-671b")  # MTP, MoE, two segments
    model = init_params(cfg, 3, device="cpu")
    opt = AdamW(model.param_groups(), lr=1e-3, quantize_v=True)
    model.requires_grad_(True)
    b = _torch(_batch(cfg))
    train_step_fn(cfg, opt)(model, b)
    params, state = to_reference_params(model), to_reference_opt_state(
        model, opt)
    back = from_reference_params(cfg, params, device="cpu")
    assert all(torch.equal(a, c) for a, c in
               zip(model.parameters(), back.parameters()))
    opt2 = AdamW(back.param_groups(), lr=1e-3, quantize_v=True)
    from_reference_opt_state(back, opt2, state)
    assert int(opt2.state["step"]) == 1
    for p, q in zip(model.parameters(), back.parameters()):
        for k, t in opt.state[p].items():
            assert torch.equal(t, opt2.state[q][k]) and \
                t.dtype == opt2.state[q][k].dtype
    with pytest.raises(ValueError, match="quantize_v"):
        from_reference_opt_state(back, AdamW(back.param_groups()), state)


def test_resume_from_reference_checkpoint(tmp_path):
    """The reference trains 3 steps into a checkpoint; the reference and the
    port each resume a copy to step 6; the port's step-6 checkpoint
    restores in the reference."""
    d, d2 = tmp_path / "ref", tmp_path / "port"
    d.mkdir()
    kw = dict(smoke=True, batch=2, seq=32, ckpt_every=3)
    ref_train("llama3.2-1b", steps=3, ckpt_dir=str(d), **kw)
    shutil.copytree(d, d2)
    want = ref_train("llama3.2-1b", steps=6, ckpt_dir=str(d), **kw)
    got = train("llama3.2-1b", steps=6, ckpt_dir=str(d2), device="cpu", **kw)
    assert got["steps_done"] == want["steps_done"] == 6
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    assert latest_step(d2) == 6
    example = {"params": want["params"],
               "opt": RefAdamW().init(want["params"])}
    back = ref_ckpt.restore_checkpoint(d2, 6, example)
    assert int(back["opt"]["step"]) == 6
    # three Adam steps of each side from one state: see the module's note
    worst, where = _worst(jax.tree.map(np.asarray, back["params"]),
                          want["params"])
    assert worst <= 1e-3, (worst, where)


def test_preemption_and_resume(tmp_path):
    """SIGTERM after step 5 (from ``on_step``, not a timer): the run
    finishes the step, checkpoints and returns; the resumed run's losses
    equal an uninterrupted run's within 1e-6."""
    kw = dict(smoke=True, steps=12, batch=2, seq=32, ckpt_every=4,
              device="cpu")
    whole = train("llama3.2-1b", ckpt_dir=str(tmp_path / "a"), **kw)

    def stop_after_5(step, loss):
        if step == 5:
            os.kill(os.getpid(), signal.SIGTERM)

    d = tmp_path / "b"
    handler = signal.getsignal(signal.SIGTERM)
    out = train("llama3.2-1b", ckpt_dir=str(d), on_step=stop_after_5, **kw)
    assert out["preempted"] and out["steps_done"] == 6 == latest_step(d)
    assert signal.getsignal(signal.SIGTERM) is handler  # restored
    rest = train("llama3.2-1b", ckpt_dir=str(d), **kw)
    assert not rest["preempted"] and rest["steps_done"] == 12
    # equal within fp32 rounding: the embedding's backward adds duplicate
    # tokens' rows with atomics once a batch is large enough to split
    np.testing.assert_allclose(out["losses"] + rest["losses"],
                               whole["losses"], rtol=1e-6)


def test_cli_exits_42_when_preempted(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "100000", "--batch", "2", "--seq", "32",
         "--ckpt-dir", str(tmp_path), "--ckpt-every", "100000"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        for line in proc.stdout:
            if line.startswith("[train] step"):
                proc.send_signal(signal.SIGTERM)
                break
        rest = proc.communicate(timeout=120)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 42, rest
    assert latest_step(tmp_path) >= 1 and "exiting for restart" in rest


def test_loss_decreases():
    """60 steps: the smoke llama learns the synthetic stream, as in the
    reference's ``tests/test_optim.py``."""
    out = train("llama3.2-1b", smoke=True, steps=60, batch=8, seq=128,
                lr=1e-3, device="cpu")
    assert out["steps_done"] == 60
    first, last = np.mean(out["losses"][:10]), np.mean(out["losses"][-10:])
    assert last < first - 0.3, (first, last)


def test_mesh_without_a_process_group_raises_as_reference():
    """A (2, 1) mesh needs two devices: the reference's host mesh asserts
    it has them (one CPU device here), the port that the process group has
    two ranks (none is initialized); both name the need."""
    from repro.launch.mesh import make_host_mesh as ref_host_mesh

    with pytest.raises(AssertionError,
                       match=r"mesh \(2, 1\) needs 2 devices, have 1"):
        ref_host_mesh((2, 1))
    with pytest.raises(ValueError,
                       match=r"mesh \(2, 1\) needs 2 devices, have 1"):
        train(mesh_shape=(2, 1), device="cpu")

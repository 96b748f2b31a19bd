"""The port's LM stack (``repro_torch.models``, ``repro_torch.configs``)
against the reference's ``repro.models`` on the CPU.

Each arch's smoke config runs in fp32 on both sides, with the reference's
weights carried across by ``from_reference_params``: the forward ``h``, the
loss (``ce``, ``aux``), the prefill logits and caches, and one decode step
from the reference's own cache must agree at rtol = atol = 1e-5 (fp32
rounding of two libraries' matmul orders over a few layers).  The port's
own invariants follow the reference's tests (``tests/test_models.py``) at
the reference's tolerances."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import ARCHS  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import LanguageModel as RefModel  # noqa: E402
from repro.models import init_cache as ref_init_cache  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.models import LanguageModel, init_cache, init_params  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    from_reference_caches,
    from_reference_params,
)
from repro_torch.models.moe import _route, moe_forward  # noqa: E402

#: fp32 parity with the reference (both on the CPU)
TOL = dict(rtol=1e-5, atol=1e-5)
B, S = 2, 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small ops, as in
    ``test_torch_train.py``: under the 6-worker test run each worker's
    thread pool spun at every op's barrier, and this file's tests took
    1.2-7x as long as with one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fp32(arch):
    r = dataclasses.replace(ref_smoke(arch), param_dtype=jnp.float32,
                            compute_dtype=jnp.float32)
    p = dataclasses.replace(port_configs.get_smoke_config(arch),
                            param_dtype=torch.float32,
                            compute_dtype=torch.float32)
    return r, p


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(port, ref, what, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, dtype=np.float32),
                               err_msg=what, **(tol or TOL))


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    fe = None
    if cfg.frontend_tokens:
        fe = rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model)
                                 ).astype(np.float32)
    return tokens, labels, fe


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_arch_matches_reference_fp32(arch):
    cfg_r, cfg_p = _fp32(arch)
    ref = RefModel(cfg_r)
    # the reference's functions under jax.jit: one compile each, where its
    # eager calls compile every primitive shape and every layer scan apart
    params = jax.jit(ref.init)(jax.random.PRNGKey(0))
    model = from_reference_params(cfg_p, _np(params), device="cpu")
    tokens, labels, fe = _inputs(cfg_p)

    h_r, aux_r, _ = jax.jit(
        lambda p, t, f: ref.forward(p, t, frontend=f))(params, _j(tokens),
                                                       _j(fe))
    loss_r, met_r = jax.jit(ref.loss)(params, _j(tokens), _j(labels),
                                      _j(fe))
    with torch.no_grad():
        h_p, aux_p, _ = model(_t(tokens), frontend=_t(fe))
        loss_p, met_p = model.loss(_t(tokens), _t(labels), frontend=_t(fe))
    _close(h_p, h_r, "forward h")
    _close(aux_p, aux_r, "forward aux")
    _close(loss_p, loss_r, "loss")
    _close(met_p["ce"], met_r["ce"], "ce")
    _close(met_p["aux"], met_r["aux"], "aux")

    caches_r = ref_init_cache(cfg_r, B, S + 4, jnp.float32)
    lg_r, c_r = jax.jit(ref.prefill)(params, _j(tokens), caches_r, _j(fe))
    caches_p = init_cache(cfg_p, B, S + 4, torch.float32, device="cpu")
    lg_p, c_p = model.prefill(_t(tokens), caches_p, frontend=_t(fe))
    _close(lg_p, lg_r, "prefill logits")
    c_r = _np(c_r)
    for si, seg in enumerate(c_r):
        for slot, leaves in seg.items():
            for k, a in leaves.items():
                _close(c_p[si][slot][k], a, f"prefill cache {si}/{slot}/{k}")

    # one decode step from the reference's own cache, on both sides
    tok = np.asarray(jnp.argmax(lg_r, -1))[:, None].astype(np.int32)
    lg2_r, c2_r = jax.jit(ref.decode_step)(params, _j(tok), c_r,
                                           jnp.int32(S))
    lg2_p, c2_p = model.decode_step(_t(tok), from_reference_caches(
        c_r, device="cpu"), S)
    _close(lg2_p, lg2_r, "decode logits")
    for si, seg in enumerate(_np(c2_r)):
        for slot, leaves in seg.items():
            for k, a in leaves.items():
                _close(c2_p[si][slot][k], a, f"decode cache {si}/{slot}/{k}")


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if ref_smoke(a).moe_experts])
def test_moe_routing_and_dispatch_match_reference(arch):
    from repro.models import moe as ref_moe

    cfg_r, cfg_p = _fp32(arch)
    params = ref_moe.moe_params(cfg_r, jax.random.PRNGKey(3))
    x = np.random.default_rng(4).standard_normal(
        (B, S, cfg_r.d_model)).astype(np.float32)
    p = {k: _t(np.asarray(v)) for k, v in params.items()}
    xt = x.reshape(-1, cfg_r.d_model)
    probs_r = jax.nn.softmax(jnp.dot(jnp.asarray(xt), params["router"]), -1)
    gate_r, eidx_r = jax.lax.top_k(probs_r, cfg_r.moe_top_k)
    probs_p, gate_p, eidx_p = _route(cfg_p, p, _t(xt))
    np.testing.assert_array_equal(eidx_p.numpy(), np.asarray(eidx_r))
    _close(probs_p, probs_r, "router probs")
    out_r, aux_r = ref_moe.moe_forward(cfg_r, params, jnp.asarray(x))
    out_p, aux_p = moe_forward(cfg_p, p, _t(x))
    _close(out_p, out_r, "moe out")
    _close(aux_p, aux_r, "moe aux")


def test_bf16_forward_matches_reference_loosely():
    """bf16 weights and activations: the two libraries round the same
    products in other orders, so h agrees to a few bf16 steps (2**-8 each)
    of its unit-scale entries: rtol = atol = 2**-4."""
    arch = "llama3.2-1b"
    cfg_r, cfg_p = ref_smoke(arch), port_configs.get_smoke_config(arch)
    ref = RefModel(cfg_r)
    params = jax.jit(ref.init)(jax.random.PRNGKey(0))
    model = from_reference_params(cfg_p, _np(params), device="cpu")
    assert model.embed.dtype == torch.bfloat16
    tokens, _, _ = _inputs(cfg_p)
    h_r, _, _ = jax.jit(ref.forward)(params, _j(tokens))
    with torch.no_grad():
        h_p, _, _ = model(_t(tokens))
    assert h_p.dtype == torch.bfloat16
    _close(h_p, h_r.astype(jnp.float32), "bf16 h", rtol=2 ** -4,
           atol=2 ** -4)


def _dtype_name(v):
    if isinstance(v, torch.dtype):
        return str(v).removeprefix("torch.")
    return jnp.dtype(v).name


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    for port, ref in ((port_configs.get_config(arch), ref_config(arch)),
                      (port_configs.get_smoke_config(arch), ref_smoke(arch))):
        names = [f.name for f in dataclasses.fields(ref)]
        assert [f.name for f in dataclasses.fields(port)] == names
        for f in names:
            a, b = getattr(port, f), getattr(ref, f)
            if f.endswith("_dtype"):
                assert _dtype_name(a) == _dtype_name(b), f
            else:
                assert a == b, f
        assert port.n_params() == ref.n_params()
        assert port.n_active_params() == ref.n_active_params()
        from repro.models.model import build_segments
        assert port_model.build_segments(port) == build_segments(ref)
    from repro.configs import SHAPES, cell_supported, input_specs
    assert list(port_configs.SHAPES) == list(SHAPES)
    for shape in SHAPES:
        assert port_configs.cell_supported(arch, shape)[0] == \
            cell_supported(arch, shape)[0]
        want = {k: (tuple(v.shape), _dtype_name(v.dtype)) for k, v in
                input_specs(ref_config(arch), shape).items()}
        got = {k: (shp, _dtype_name(dt)) for k, (shp, dt) in
               port_configs.input_specs(port_configs.get_config(arch),
                                        shape).items()}
        assert got == want


# ---------------------------------------------------------------------------
# the port's own invariants (the reference's tests/test_models.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b",
                                  "jamba-1.5-large-398b", "deepseek-v3-671b"])
def test_prefill_decode_consistency(arch):
    """logits from (prefill T) + (decode k steps) == forward over T+k."""
    cfg = dataclasses.replace(port_configs.get_smoke_config(arch),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32,
                              capacity_factor=64.0)
    model = init_params(cfg, 1, device="cpu")
    T, K = 32, 4
    seq = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, T + K)).astype(np.int32))
    with torch.no_grad():
        h, _, _ = model(seq)
        want = h[:, T - 1:T + K - 1] @ model.head
    caches = init_cache(cfg, B, T + K + 2, torch.float32, device="cpu")
    logits, caches = model.prefill(seq[:, :T], caches)
    tol = dict(rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(logits, want[:, 0], **tol)
    for k in range(1, K):
        logits, caches = model.decode_step(seq[:, T + k - 1:T + k], caches,
                                           T + k - 1)
        torch.testing.assert_close(logits, want[:, k], **tol)


def test_attention_chunking_invariance():
    cfg = dataclasses.replace(port_configs.get_smoke_config("llama3.2-1b"),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    model = init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32))
    with torch.no_grad():
        h1, _, _ = model(toks)
        model.cfg = dataclasses.replace(cfg, q_chunk=16)
        h2, _, _ = model(toks)
    torch.testing.assert_close(h1, h2, rtol=1e-5, atol=1e-5)


def test_ssm_chunk_invariance():
    cfg = dataclasses.replace(port_configs.get_smoke_config("mamba2-1.3b"),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    model = init_params(cfg, 3, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32))
    with torch.no_grad():
        h1, _, _ = model(toks)
        for q in (8, 16, 64):
            model.cfg = dataclasses.replace(cfg, ssm_chunk=q)
            h2, _, _ = model(toks)
            torch.testing.assert_close(h1, h2, rtol=5e-4, atol=5e-4)


def test_seeded_init_repeats_and_step_fns():
    cfg = port_configs.get_smoke_config("yi-6b")
    a, b = init_params(cfg, 7, device="cpu"), init_params(cfg, 7, device="cpu")
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    # the reference's count leaves out the final norm
    assert sum(p.numel() for p in a.parameters()) == \
        cfg.n_params() + cfg.d_model
    toks = torch.zeros((1, 8), dtype=torch.int32)
    caches = init_cache(cfg, 1, 9, device="cpu")
    lg, caches = port_model.prefill_step_fn(cfg)(a, {"tokens": toks}, caches)
    lg2, _ = port_model.decode_step_fn(cfg)(a, toks[:, :1], caches, 8)
    assert lg.shape == lg2.shape == (1, cfg.vocab)
    with pytest.raises(ValueError, match="another config"):
        port_model.decode_step_fn(port_configs.get_smoke_config("yi-9b"))(
            a, toks[:, :1], caches, 8)


def test_lm_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_configs.get_smoke_config("llama3.2-1b")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        LanguageModel(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_reference_caches([])
    assert init_params(cfg, 0, device="cpu").device.type == "cpu"

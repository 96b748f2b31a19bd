"""The port's optimizer (``repro_torch.optim``) against the reference's
``repro.optim`` on the CPU: the same arrays and gradients through both
``AdamW`` updates, at the reference's own tolerance (rtol 1e-5, atol 1e-6,
``tests/test_optim.py``); the int8 second moment's codes equal except
for a step of one at rounding ties (at most 1 % of the entries, whose
later updates are then left out), its scales at rtol 1e-6; the schedule
within 2**-23 of its base rate (the two libraries' float32 cosines differ
by an ulp, 2**-24 near -1, and 1 + cos cancels near the end)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import cosine_schedule as ref_cosine  # noqa: E402
from repro_torch.optim import AdamW, cosine_schedule  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = {"w": (64, 32), "b": (32,), "s": (3, 16, 8)}


def _arrays(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


class _Pair:
    """The same parameters under the reference's and the port's AdamW."""

    def __init__(self, p0, schedule=None, **kw):
        """``schedule``: ``cosine_schedule``'s arguments, in place of a
        constant ``lr``."""
        self.ref = RefAdamW(**(dict(kw, lr=ref_cosine(*schedule))
                               if schedule else kw))
        self.rp = {k: jnp.asarray(v) for k, v in p0.items()}
        self.rs = self.ref.init(self.rp)
        if schedule:
            kw["lr"] = cosine_schedule(*schedule)
        self.tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                   for k, v in p0.items()}
        self.opt = AdamW(list(self.tp.values()), **kw)
        #: entries whose int8 code rounded the other way at a tie, at this
        #: step or before: their later updates differ by a code's worth
        self.tied = {k: np.zeros(v.shape, bool) for k, v in p0.items()}

    def step(self, grads):
        self.rp, self.rs = self.ref.update(
            self.rp, {k: jnp.asarray(v) for k, v in grads.items()}, self.rs)
        for k, p in self.tp.items():
            p.grad = torch.from_numpy(grads[k])
        self.opt.step()

    def check(self, quantized: bool):
        assert int(self.opt.state["step"]) == int(self.rs["step"])
        assert self.opt.state["step"].dtype == torch.int32
        for k, p in self.tp.items():
            live = ~self.tied[k]
            np.testing.assert_allclose(p.detach().numpy()[live],
                                       np.asarray(self.rp[k])[live],
                                       err_msg=k, **TOL)
            st, rst = self.opt.state[p], self.rs["mu"][k]
            assert set(st) == set(rst)
            np.testing.assert_allclose(st["m"].numpy(), np.asarray(rst["m"]),
                                       err_msg=k, **TOL)
            if not quantized:
                np.testing.assert_allclose(st["v"].numpy(),
                                           np.asarray(rst["v"]), err_msg=k,
                                           **TOL)
                continue
            vq, rvq = st["vq"].numpy().astype(int), np.asarray(rst["vq"])
            assert st["vq"].dtype == torch.int8
            # a code may round the other way only at a tie
            assert np.abs(vq - rvq).max() <= 1, k
            self.tied[k] |= vq != rvq
            assert self.tied[k].mean() <= 0.01, k
            np.testing.assert_allclose(st["vs"].numpy(),
                                       np.asarray(rst["vs"]), rtol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("case", ["clip_active", "clip_inactive",
                                  "quantize_v"])
def test_one_update_matches_reference(case):
    rng = np.random.default_rng(0)
    p0 = _arrays(rng)
    # gradients of global norm about 40 (clipped to 1) or 0.4 (not)
    g = _arrays(rng, 1.0 if case == "clip_active" else 0.01)
    kw = dict(lr=1e-2, weight_decay=0.1, quantize_v=case == "quantize_v")
    if case == "clip_inactive":  # a schedule of the step for the lr
        kw = dict(kw, lr=None, schedule=(1e-2, 1, 10))
    pair = _Pair(p0, **kw)
    pair.step(g)
    pair.check(case == "quantize_v")
    if case == "clip_active":  # the clip did act: the moments saw g / gnorm
        gnorm = np.sqrt(sum(np.sum(v.astype(np.float64) ** 2)
                            for v in g.values()))
        m = pair.opt.state[pair.tp["w"]]["m"].numpy()
        np.testing.assert_allclose(m, 0.1 * g["w"] / gnorm, rtol=1e-5)


def test_ten_quantized_steps_match_reference():
    rng = np.random.default_rng(1)
    pair = _Pair(_arrays(rng), lr=1e-2, quantize_v=True)
    for _ in range(10):
        pair.step(_arrays(rng, 0.3))
        pair.check(quantized=True)


def test_decay_counts_the_layer_axis_of_stacked_groups():
    """A 1-D parameter decays in a ``stacked`` group (the reference stacks
    it to 2-D) and not in a plain one."""
    p = [torch.nn.Parameter(torch.ones(4)) for _ in range(2)]
    opt = AdamW([{"params": [p[0]]}, {"params": [p[1]], "stacked": True}],
                lr=0.5, weight_decay=0.1)
    for q in p:
        q.grad = torch.zeros(4)
    opt.step()
    assert torch.equal(p[0].detach(), torch.ones(4))
    assert torch.allclose(p[1].detach(), torch.full((4,), 1 - 0.5 * 0.1))


def test_cosine_schedule_matches_reference():
    want = np.array([float(ref_cosine(1e-3, 6, 120)(s)) for s in range(121)],
                    np.float32)
    got = np.array([float(cosine_schedule(1e-3, 6, 120)(s))
                    for s in range(121)], np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -23 * 1e-3)
    lr = cosine_schedule(1.0, warmup=10, total=110)
    assert float(lr(0)) == 0.0 and abs(float(lr(10)) - 1.0) < 1e-6
    assert float(lr(110)) < 1e-6


def test_block_quantizers_match_reference():
    x = np.random.default_rng(2).standard_normal((5, 77)).astype(np.float32)
    q, s = adamw._quantize_i8(torch.from_numpy(x))
    rq, rs = ref_adamw._quantize_i8(jnp.asarray(x))
    assert np.abs(q.numpy().astype(int) - np.asarray(rq)).max() <= 1
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-6)
    np.testing.assert_allclose(
        adamw._dequantize_i8(q, s, x.shape).numpy(),
        np.asarray(ref_adamw._dequantize_i8(rq, rs, x.shape)), rtol=1e-5,
        atol=1e-6)
    v = np.abs(x)
    np.testing.assert_allclose(
        adamw._dequantize_v(*adamw._quantize_v(torch.from_numpy(v)),
                            v.shape).numpy(),
        np.asarray(ref_adamw._dequantize_v(*ref_adamw._quantize_v(
            jnp.asarray(v)), v.shape)), rtol=1e-5, atol=1e-6)


def test_quantized_state_is_smaller():
    def state_bytes(quantize_v):
        p = torch.nn.Parameter(torch.zeros(1024, 1024))
        opt = AdamW([p], quantize_v=quantize_v)
        return sum(t.numel() * t.element_size()
                   for t in opt.moments(p).values())

    assert state_bytes(True) < 0.7 * state_bytes(False)

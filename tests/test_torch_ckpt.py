"""The port's data stream and checkpoints (``repro_torch.data``,
``repro_torch.ckpt``) on the CPU: batches bit-identical to the reference's
``repro.data``, the reference's checkpoint properties (round trip,
keep-last, shape check, atomic publish, async write of a copy), and
checkpoints written by either package restored by the other."""
import json
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.ckpt as ref_ckpt  # noqa: E402
from repro.data import SyntheticTextDataset as RefDataset  # noqa: E402
from repro.data import make_train_iterator as ref_iterator  # noqa: E402
from repro_torch.ckpt import (  # noqa: E402
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.ckpt import checkpoint as ckpt_mod  # noqa: E402
from repro_torch.data import (  # noqa: E402
    SyntheticTextDataset,
    make_train_iterator,
)


def _equal(a, b) -> bool:
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_batches_bit_identical_to_reference(seed):
    for shard in (0, 1):
        kw = dict(vocab=1000, seq_len=48, batch=3, seed=seed, num_shards=2,
                  shard=shard)
        ds, ref = SyntheticTextDataset(**kw), RefDataset(**kw)
        for step in (0, 1, 17, 250):
            got, want = ds.batch_at(step), ref.batch_at(step)
            assert set(got) == set(want) == {"tokens", "labels"}
            for k in got:
                assert got[k].dtype == want[k].dtype == np.int32
                assert np.array_equal(got[k], want[k])
        it = make_train_iterator(1000, 48, 3, seed=seed, num_shards=2,
                                 shard=shard, start_step=5)
        rit = ref_iterator(1000, 48, 3, seed=seed, num_shards=2, shard=shard,
                           start_step=5)
        for _ in range(3):
            (s, b), (rs, rb) = next(it), next(rit)
            assert s == rs and all(np.array_equal(b[k], rb[k]) for k in b)


def _tree():
    """Unsorted keys, a list, an int32 scalar."""
    return {"z": torch.arange(12.0).reshape(3, 4),
            "a": [torch.ones(5), torch.tensor(7, dtype=torch.int32)],
            "m": {"y": torch.full((2,), 2.5), "b": torch.zeros((1, 3))}}


def _leaves_equal(a, b) -> bool:
    la, lb = list(ckpt_mod._leaves(a)), list(ckpt_mod._leaves(b))
    return len(la) == len(lb) and all(
        _equal(x, y) and np.asarray(x).dtype == np.asarray(y).dtype
        for x, y in zip(la, lb))


def test_save_restore_roundtrip(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path, 3, tree)
    assert latest_step(tmp_path) == 3
    restored = restore_checkpoint(tmp_path, 3, tree, device="cpu")
    assert list(restored) == list(tree) and isinstance(restored["a"], list)
    assert _leaves_equal(tree, restored)
    meta = json.loads((tmp_path / "step_000000003" / "meta.json").read_text())
    assert meta["step"] == 3 and meta["n_leaves"] == 5


def test_bfloat16_leaf_roundtrip(tmp_path):
    x = torch.randn(4, 3).to(torch.bfloat16)
    save_checkpoint(tmp_path, 1, {"x": x, "y": torch.ones(2)})
    with np.load(tmp_path / "step_000000001" / "arrays.npz") as data:
        assert data["leaf_0"].dtype == np.uint16
    back = restore_checkpoint(tmp_path, 1, {"x": x, "y": torch.ones(2)},
                              device="cpu")
    assert back["x"].dtype == torch.bfloat16 and torch.equal(back["x"], x)


def test_keep_last_gc(tmp_path):
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(tmp_path, s, {"x": torch.zeros(4)}, keep_last=2)
    assert len(list(tmp_path.glob("step_*"))) == 2
    assert latest_step(tmp_path) == 5


def test_restore_validates_shapes(tmp_path):
    save_checkpoint(tmp_path, 1, {"x": torch.zeros((2, 2))})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(tmp_path, 1, {"x": torch.zeros((3, 3))},
                           device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(tmp_path, 1, {"x": torch.zeros((2, 2)),
                                         "y": torch.zeros(1)}, device="cpu")


def test_no_tmp_dirs_left(tmp_path):
    save_checkpoint(tmp_path, 1, {"x": torch.zeros(3)})
    assert not list(tmp_path.glob("*.tmp"))


def test_async_checkpointer(tmp_path):
    ck = AsyncCheckpointer(tmp_path)
    tree = {"w": torch.arange(100.0)}
    ck.save(7, tree)
    ck.wait()
    assert latest_step(tmp_path) == 7
    assert _leaves_equal(tree, restore_checkpoint(tmp_path, 7, tree,
                                                  device="cpu"))


def test_async_save_writes_a_snapshot(tmp_path, monkeypatch):
    """The tensor is changed in place right after ``save`` returns, before
    the background write starts: the file holds the values at ``save``."""
    go = threading.Event()
    write = ckpt_mod._write

    def held(*args, **kw):
        assert go.wait(30)
        return write(*args, **kw)

    monkeypatch.setattr(ckpt_mod, "_write", held)
    w = torch.arange(10.0)
    ck = AsyncCheckpointer(tmp_path)
    ck.save(1, {"w": w})
    w.mul_(-1.0)  # the optimizer's next in-place step
    go.set()
    ck.wait()
    back = restore_checkpoint(tmp_path, 1, {"w": w}, device="cpu")
    assert torch.equal(back["w"], torch.arange(10.0))


def test_async_write_error_is_raised_on_wait(tmp_path):
    (tmp_path / "f").write_text("")  # a file where the directory goes
    ck = AsyncCheckpointer(tmp_path / "f")
    ck.save(1, {"x": torch.zeros(2)})
    with pytest.raises(OSError):
        ck.wait()


def test_reference_checkpoint_restores_in_port(tmp_path):
    ref_tree = {"z": jnp.arange(12.0).reshape(3, 4),
                "a": [jnp.ones(5), jnp.int32(7)],
                "m": {"y": jnp.full((2,), 2.5), "b": jnp.zeros((1, 3))}}
    ref_ckpt.save_checkpoint(tmp_path, 4, ref_tree)
    assert latest_step(tmp_path) == 4
    back = restore_checkpoint(tmp_path, 4, _tree(), device="cpu")
    assert back["a"][1].dtype == torch.int32
    assert _leaves_equal(jax.tree.map(np.asarray, ref_tree), back)


def test_port_checkpoint_restores_in_reference(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path, 9, tree)
    assert ref_ckpt.latest_step(tmp_path) == 9
    example = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)
    back = ref_ckpt.restore_checkpoint(tmp_path, 9, example)
    assert jax.tree.structure(back) == jax.tree.structure(example)
    assert all(_equal(x, y) and x.dtype == y.dtype for x, y in
               zip(jax.tree.leaves(back), jax.tree.leaves(example)))

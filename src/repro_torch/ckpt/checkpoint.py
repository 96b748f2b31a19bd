"""Checkpointing (port of ``src/repro/ckpt/checkpoint.py``), with the
reference's properties and its file layout:

  * atomic:    written to step_NNN.tmp/, fsync'd, then renamed — a
               preemption mid-write never corrupts the latest checkpoint;
  * resumable: latest_step() scans the directory, restore reproduces the
               tree (shapes validated against an example tree);
  * async:     AsyncCheckpointer copies the tree to host memory
               synchronously and writes in a background thread, one write
               outstanding at a time;
  * bounded:   keep_last garbage-collects old steps.

A checkpoint is ``arrays.npz`` with ``leaf_i`` in the order
``jax.tree.flatten`` gives a tree (dict keys sorted at every level, lists
and tuples in order, ``None`` holding no leaf) and ``meta.json`` with
``step`` and ``n_leaves``.  The reference's restore reads only the arrays
and checks only shapes, so a checkpoint written by either package restores
in the other.  numpy has no bfloat16 of its own: a bfloat16 tensor is
written as its ``uint16`` bits and ``meta.json`` lists its index under
``"bfloat16"`` (the reference reads those leaves as ``uint16``).

Leaves may be tensors (on any device), numpy arrays or Python scalars;
``restore_checkpoint`` returns tensors on ``device`` (the card unless
``"cpu"``).  Restoring onto another mesh, the reference's ``shardings=``,
comes with multi-device training.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading

import numpy as np
import torch

from repro_torch.device import resolve_device


def _leaves(tree):
    """The leaves of ``tree`` in ``jax.tree.flatten``'s order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _leaves(t)
    elif tree is not None:
        yield tree


def _rebuild(tree, it):
    """``tree``'s structure with its leaves taken from the iterator ``it``
    (in ``_leaves``' order)."""
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, it) for t in tree)
    return None if tree is None else next(it)


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array (bfloat16 as its uint16 bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _snapshot(leaf):
    """A host copy of a leaf, never a view: on the CPU ``t.cpu()`` returns
    the same storage, which the caller goes on to update in place."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def save_checkpoint(ckpt_dir, step: int, tree, *,
                    keep_last: int = 3) -> pathlib.Path:
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"step_{step:09d}.tmp"
    final = ckpt_dir / f"step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    leaves = list(_leaves(tree))
    meta = {"step": step, "n_leaves": len(leaves),
            "bfloat16": [i for i, leaf in enumerate(leaves)
                         if isinstance(leaf, torch.Tensor)
                         and leaf.dtype == torch.bfloat16]}
    np.savez(tmp / "arrays.npz", **{f"leaf_{i}": _host(leaf)
                                    for i, leaf in enumerate(leaves)})
    (tmp / "meta.json").write_text(json.dumps(meta))
    # fsync the directory entries before the atomic publish
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    # GC old steps
    steps = sorted(p for p in ckpt_dir.glob("step_*")
                   if not p.name.endswith(".tmp"))
    for old in steps[:-keep_last]:
        shutil.rmtree(old, ignore_errors=True)
    return final


def latest_step(ckpt_dir) -> int | None:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(
        int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
        if not p.name.endswith(".tmp")
    )
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir, step: int, example_tree, *, device=None):
    """Restore into the structure of ``example_tree`` (its leaves need only
    a ``shape``): tensors of the saved dtypes on ``device``."""
    dev = resolve_device(device)
    path = pathlib.Path(ckpt_dir) / f"step_{step:09d}"
    meta = json.loads((path / "meta.json").read_text())
    bf16 = set(meta.get("bfloat16", ()))
    leaves = list(_leaves(example_tree))
    if meta["n_leaves"] != len(leaves):
        raise ValueError(f"checkpoint has {meta['n_leaves']} leaves, the "
                         f"example tree {len(leaves)}")
    restored = []
    with np.load(path / "arrays.npz") as data:
        for i, ex in enumerate(leaves):
            arr = data[f"leaf_{i}"]
            ex_shape = tuple(getattr(ex, "shape", ()))
            if tuple(arr.shape) != ex_shape:
                raise ValueError(f"checkpoint leaf {i} shape {arr.shape} != "
                                 f"expected {ex_shape}")
            if i in bf16:
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            restored.append(t.to(dev))
    return _rebuild(example_tree, iter(restored))


class AsyncCheckpointer:
    """Copy to host memory synchronously, write in a background thread."""

    def __init__(self, ckpt_dir, *, keep_last: int = 3):
        self.ckpt_dir = pathlib.Path(ckpt_dir)
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree):
        self.wait()  # one outstanding write at a time
        host = [_snapshot(leaf) for leaf in _leaves(tree)]

        def _write():
            try:
                save_checkpoint(self.ckpt_dir, step, host,
                                keep_last=self.keep_last)
            except Exception as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

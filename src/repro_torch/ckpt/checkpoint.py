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

Leaves may be tensors (on any device), DTensors, numpy arrays or Python
scalars; ``restore_checkpoint`` returns tensors on ``device`` (the card
unless ``"cpu"``), or, given ``shardings=``, DTensors laid out as asked on
any mesh: a checkpoint written from one mesh restores on another (the
elastic restore).

On a mesh every rank calls ``save_checkpoint`` and ``AsyncCheckpointer``'s
methods: a DTensor leaf is written whole (its all-gather is a collective),
rank 0 writes the files, and the calls return on every rank once they are
on disk.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.device import resolve_device
from repro_torch.models.common import active_mesh


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


def _many() -> bool:
    """Whether this process is one of several ranks of a process group."""
    return dist.is_initialized() and dist.get_world_size() > 1


def _writes() -> bool:
    """Whether this rank writes checkpoint files (rank 0 of a group)."""
    return not _many() or dist.get_rank() == 0


def _whole(leaf):
    """A DTensor leaf's whole tensor (a collective), any other as it is."""
    return leaf.full_tensor() if isinstance(leaf, DTensor) else leaf


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
    leaf = _whole(leaf)
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def save_checkpoint(ckpt_dir, step: int, tree, *,
                    keep_last: int = 3) -> pathlib.Path:
    ckpt_dir = pathlib.Path(ckpt_dir)
    leaves = [_whole(leaf) for leaf in _leaves(tree)]
    if _writes():
        _write(ckpt_dir, step, leaves, keep_last)
    if _many():
        dist.barrier()
    return ckpt_dir / f"step_{step:09d}"


def _write(ckpt_dir: pathlib.Path, step: int, leaves: list,
           keep_last: int) -> None:
    """Write one checkpoint of ``leaves`` (no DTensor among them)."""
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"step_{step:09d}.tmp"
    final = ckpt_dir / f"step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
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


def latest_step(ckpt_dir) -> int | None:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(
        int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
        if not p.name.endswith(".tmp")
    )
    return steps[-1] if steps else None


def _paired(example, shardings):
    """The node of ``shardings`` at each leaf of ``example``, in
    ``_leaves``' order (a shardings leaf may itself be a tuple)."""
    if isinstance(example, dict):
        for k in sorted(example):
            yield from _paired(example[k], shardings[k])
    elif isinstance(example, (list, tuple)):
        for e, s in zip(example, shardings):
            yield from _paired(e, s)
    elif example is not None:
        yield shardings


def _place(t: torch.Tensor, sharding) -> DTensor:
    """A whole tensor as a DTensor: ``sharding`` is a tuple of placements
    over the active mesh, or ``(mesh, placements)``; every rank holds the
    whole tensor and keeps its shard."""
    if sharding and isinstance(sharding[0], DeviceMesh):
        mesh, placements = sharding
    else:
        mesh, placements = active_mesh(), sharding
    if mesh is None:
        raise ValueError("placements without a mesh: pass (mesh, "
                         "placements) or set an active mesh")
    return distribute_tensor(t.to(mesh.device_type), mesh, tuple(placements),
                             src_data_rank=None)


def restore_checkpoint(ckpt_dir, step: int, example_tree, *, device=None,
                       shardings=None):
    """Restore into the structure of ``example_tree`` (its leaves need only
    a ``shape``): tensors of the saved dtypes on ``device``, or with
    ``shardings`` (a tree like ``example_tree`` of placements or of
    ``(mesh, placements)``) DTensors laid out as asked."""
    dev = resolve_device(device)
    places = (list(_paired(example_tree, shardings))
              if shardings is not None else None)
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
            restored.append(t.to(dev) if places is None
                            else _place(t.to(dev), places[i]))
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
        if _many():  # rank 0's write is on disk for every rank
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree):
        self.wait()  # one outstanding write at a time
        host = [_snapshot(leaf) for leaf in _leaves(tree)]
        if not _writes():
            return

        def _write_bg():
            try:
                _write(self.ckpt_dir, step, host, self.keep_last)
            except Exception as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_write_bg, daemon=True)
        self._thread.start()

"""Mesh construction (port of ``src/repro/launch/mesh.py``) on
``torch.distributed``.

Single pod: 16 x 16 = 256 ranks, axes (data, model).
Multi-pod:  2 x 16 x 16 = 512 ranks, axes (pod, data, model); the pod axis
extends data parallelism across the (slower) cross-pod links, so gradient
all-reduce is the only traffic that crosses pods in the training layout.

Each is an ``init_device_mesh`` over the process group the caller
initialized (``torch.distributed.init_process_group`` with its own address,
world size and rank), one rank per device.  Functions, not constants, so
importing this module touches no process group.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_host_mesh(shape, axes, device=device)


def make_host_mesh(shape: tuple[int, ...] = (1, 1),
                   axes: tuple[str, ...] = ("data", "model"), device=None):
    """A mesh of ``shape`` over the initialized process group, whose world
    size must be the shape's product (the reference asserts that the local
    devices suffice), on ``device`` ("cuda" unless "cpu")."""
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise ValueError(f"mesh {tuple(shape)} needs {n} devices, have "
                         f"{world} (the process group's world size)")
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


# Hardware model (one NVIDIA H100 SXM5) for a roofline analysis; every value
# from NVIDIA's H100 Tensor Core GPU datasheet.
HW = {
    "peak_flops": 989e12,   # dense bf16 tensor-core FLOP/s
    "hbm_bw": 3.35e12,      # HBM3 bytes/s
    "ici_bw": 450e9,        # NVLink 4, bytes/s each way (900 GB/s total
                            # over its 18 links)
    "hbm_per_chip": 80e9,   # bytes of HBM3
}

# NVLink joins only the 8 GPUs of one node (DGX / HGX H100); a node reaches
# the others over one 400 Gb/s ConnectX-7 NIC per GPU (DGX H100 datasheet).
# Ranks lie ``gpus_per_node`` to a node in rank order (torchrun's layout).
NET = {
    "gpus_per_node": 8,
    "net_bw": 50e9,         # bytes/s each way a GPU, off the node
}

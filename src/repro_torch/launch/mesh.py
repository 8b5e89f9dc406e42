"""Meshes over the world's ranks, as ``repro.launch.mesh``.

``make_host_mesh`` builds a ``DeviceMesh`` over the ranks of the default
process group, which the caller starts (``torch.distributed.
init_process_group``; one rank a card on NCCL, or gloo CPU ranks).  The
device type follows the group's backend: ``cuda`` on NCCL, ``cpu``
otherwise.

Not ported: ``make_production_mesh``, whose (16, 16) and (2, 16, 16)
shapes name TPU v5e pod slices; a GPU deployment passes its own shape to
``make_host_mesh``.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_host_mesh(shape=None, axes=None):
    """A mesh over every rank of the default group: by default
    ``(1, world, 1)`` over ``("pod", "data", "model")``, as in the JAX
    package; ``shape`` and ``axes`` name another layout, whose sizes
    multiply to the world size."""
    n = dist.get_world_size()
    if shape is None:
        shape, axes = (1, n, 1), ("pod", "data", "model")
    shape, axes = tuple(shape), tuple(axes)
    size = 1
    for s in shape:
        size *= s
    if size != n:
        raise ValueError(f"mesh {shape} holds {size} ranks; the world has "
                         f"{n}")
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, shape, mesh_dim_names=axes)

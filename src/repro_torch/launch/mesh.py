"""Meshes over the world's ranks, as ``repro.launch.mesh``.

``make_host_mesh`` builds a ``DeviceMesh`` over the ranks of the default
process group, which the caller starts (``torch.distributed.
init_process_group``; one rank a card on NCCL, or gloo CPU ranks).  The
device type follows the group's backend: ``cuda`` on NCCL, ``cpu``
otherwise.

``stand_in_mesh`` builds the mesh of one rank of a larger world on a
process group with no peers: the per-rank dry run
(:mod:`repro_torch.launch.dryrun`, ``--mesh``) runs one rank of the JAX
package's production layouts, ``MESHES["single"]`` (the JAX ``(16, 16)``
over ``("data", "model")``, here ``(1, 16, 16)``) and ``MESHES["multi"]``
(``(2, 16, 16)``), on ``meta`` tensors.  Its collectives return at once
and move nothing; the counters still see each one
(:mod:`repro_torch.core.distributed`).
"""
from __future__ import annotations

import contextlib
import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

AXES = ("pod", "data", "model")
#: the per-rank dry run's layouts: the JAX production meshes on the port's
#: axes
MESHES = {"single": (1, 16, 16), "multi": (2, 16, 16)}


@contextlib.contextmanager
def stand_in_mesh(shape, rank: int = 0, axes=AXES):
    """A ``DeviceMesh`` of ``shape`` over ``axes`` as rank ``rank`` of a
    world of ``prod(shape)`` ranks sees it, on PyTorch's fake process
    group (no peers, collectives that return at once): for tensors on
    ``meta``.  Refuses to start when a default group exists; destroys the
    group on exit."""
    if dist.is_initialized():
        raise RuntimeError("stand_in_mesh: a default process group already "
                           "exists")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:           # no stand-in group: refuse to run
        raise RuntimeError("stand_in_mesh: this PyTorch has no fake process "
                           "group (torch.testing._internal.distributed."
                           "fake_pg)") from e
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", tuple(shape),
                               mesh_dim_names=tuple(axes))
    finally:
        dist.destroy_process_group()


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

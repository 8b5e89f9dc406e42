"""Elastic scaling: resume a run on a different topology.

The port of ``repro.train.elastic``.  Checkpoints are topology-agnostic
(whole logical tensors), so elasticity reduces to (a) choosing a mesh for
the ranks that are healthy now, and (b) taking each rank's shard of the
restored tree.  ``plan_mesh`` picks the largest (data, model)
factorization from a rank count; ``reshard_tree`` cuts a restored tree to
the rank's local view.  The ``Trainer`` takes its shards on resume
itself; a run restarted with fewer ranks (``torchrun`` with a smaller
``--nproc-per-node``) plans its mesh here.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .._tree import tree_map
from ..models import sharding as shmod
from ..models.sharding import AXES, TensorLayout


def plan_mesh(n_devices: Optional[int] = None,
              model_parallel: int = 16) -> DeviceMesh:
    """Largest usable (data, model) mesh over the first ranks of the
    world.

    Keeps the TP degree fixed, gives the remainder to the data axis, and
    leaves out ranks that don't factorize (e.g. 511 ranks -> a 31 x 16
    mesh, 15 spares idle).  Every rank of the world calls it; a rank left
    out gets a mesh it is not part of."""
    world = dist.get_world_size()
    n = n_devices if n_devices is not None else world
    if n > world:
        # a "resume on 512" request must not quietly resume on 8
        raise ValueError(
            f"plan_mesh: requested n_devices={n} but only {world} "
            f"ranks are healthy — pass n_devices<={world} (or None "
            f"to use all healthy ranks)")
    if n < 1:
        raise ValueError(f"plan_mesh: n_devices must be >= 1, got {n}")
    mp = min(model_parallel, n)
    while n % mp and mp > 1:
        mp -= 1
    dp = n // mp
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device, torch.arange(dp * mp).reshape(dp, mp),
                      mesh_dim_names=("data", "model"))


def reshard_tree(tree: Any, mesh) -> Any:
    """This rank's shard of every leaf of a (restored, whole) tree under
    the standard parameter rules: views of the leaves."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not part of the mesh")
    names = tuple(mesh.mesh_dim_names)
    at = dict(zip(names, coord))
    sizes = shmod.axis_sizes(mesh)
    sizes = {a: sizes.get(a, 1) for a in AXES}
    at = {a: at.get(a, 0) for a in AXES}
    with shmod.use_mesh(mesh):
        specs = shmod.tree_param_specs(tree)
    return tree_map(lambda x, s: TensorLayout(s, x.shape, sizes, at).shard(x),
                    tree, specs)

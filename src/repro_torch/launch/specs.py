"""Input stand-ins and their mesh specs for every (arch x shape) cell: the
port of ``repro.launch.specs``.

JAX describes a cell's inputs as ``ShapeDtypeStruct`` s; here they are
tensors on the ``meta`` device by default (names, shapes and dtypes, no
memory), or empty tensors on another device for :func:`draw` to fill.

On a mesh (a ``DeviceMesh`` or a :class:`~repro_torch.models.sharding.
MeshLayout`) the ``mesh_*`` functions give each input's whole stand-in and
its spec, one entry a dimension, by the JAX module's rules as they stand:
the batch over ``("pod", "data")`` where it divides, else over ``"data"``,
else replicated (:func:`batch_spec`); the decode state's caches over
``"model"`` by KV heads where they divide, else by the head dimension,
and their sequence over ``"data"`` when the batch does not split
(:func:`mesh_decode_state_specs`).  A rank's part of an input is
:func:`local`'s: ``TensorLayout(spec, shape, ...)``'s shard.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .._tree import tree_map
from ..configs.base import ArchConfig, ShapeConfig
from ..models import build_model
from ..models.layers import cdtype
from ..models.sharding import P, TensorLayout, axis_sizes


def param_specs(cfg: ArchConfig, device="meta"):
    """The params nest of ``cfg``'s model (the JAX names, shapes and param
    dtypes) as meta tensors: a model built on meta draws nothing."""
    return build_model(cfg, device=device).param_tree()


def train_batch_specs(cfg: ArchConfig, shape: ShapeConfig,
                      device="meta") -> Dict[str, torch.Tensor]:
    """The training batch: ``tokens`` and ``labels`` (B, S) int32, and the
    VLM's ``patch_embeds`` (B, n_patches, d) or the enc-dec's ``frames``
    (B, n_frames, d) in the compute dtype."""
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": torch.empty((b, s), dtype=torch.int32, device=device),
           "labels": torch.empty((b, s), dtype=torch.int32, device=device)}
    if cfg.family == "vlm":
        out["patch_embeds"] = torch.empty((b, cfg.n_patches, cfg.d_model),
                                          dtype=cdtype(cfg), device=device)
    if cfg.family == "encdec":
        out["frames"] = torch.empty((b, cfg.n_frames, cfg.d_model),
                                    dtype=cdtype(cfg), device=device)
    return out


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeConfig,
                        device="meta") -> Dict[str, torch.Tensor]:
    """The prefill batch: :func:`train_batch_specs` without ``labels``."""
    out = train_batch_specs(cfg, shape, device)
    del out["labels"]
    return out


def decode_state_specs(cfg: ArchConfig, shape: ShapeConfig, model=None):
    """The decode state of ``shape.global_batch`` slots and a cache of
    ``shape.seq_len`` positions: ``init_decode_state`` of ``model`` (by
    default a model built on meta, whose state is meta too)."""
    model = model if model is not None else build_model(cfg, device="meta")
    return model.init_decode_state(shape.global_batch, shape.seq_len)


def decode_input_specs(cfg: ArchConfig, shape: ShapeConfig,
                       device="meta") -> torch.Tensor:
    """One token a slot: (B,) int32."""
    return torch.empty((shape.global_batch,), dtype=torch.int32,
                       device=device)


def draw(tree: Any, seed: int, vocab: int) -> Any:
    """``tree``'s tensors refilled in place from a generator seeded with
    ``seed`` on their device: integer leaves uniform token ids below
    ``vocab``, floating leaves N(0, 1).  Returns ``tree``."""
    gens: Dict[Tuple[str, Any], torch.Generator] = {}

    def fill(t):
        if not isinstance(t, torch.Tensor):
            return t
        key = (t.device.type, t.device.index)
        if key not in gens:
            gens[key] = torch.Generator(device=t.device)
            gens[key].manual_seed(seed)
        with torch.no_grad():
            if t.dtype.is_floating_point:
                t.normal_(generator=gens[key])
            else:
                t.random_(0, vocab, generator=gens[key])
        return t
    return tree_map(fill, tree)


# ------------------------------------------------------------- mesh specs
def _batch_axes(mesh) -> Tuple[str, ...]:
    return (("pod", "data") if "pod" in mesh.mesh_dim_names
            else ("data",))


def _div(n: int, mesh, axes) -> bool:
    sizes = axis_sizes(mesh)
    size = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        size *= sizes[a]
    return n % size == 0


def batch_spec(mesh, n: int) -> Optional[Tuple[str, ...]]:
    """The axes a batch of ``n`` rows splits over: ``("pod", "data")``
    (or ``("data",)`` without a pod axis) where their product divides
    ``n``, else ``("data",)`` where it divides, else None
    (replicated)."""
    ba = _batch_axes(mesh)
    if _div(n, mesh, ba):
        return ba
    if _div(n, mesh, ("data",)):
        return ("data",)
    return None


def mesh_train_batch_specs(cfg: ArchConfig, shape: ShapeConfig, mesh,
                           device="meta"):
    """(:func:`train_batch_specs`, {name: spec}): every input's rows over
    :func:`batch_spec`."""
    structs = train_batch_specs(cfg, shape, device)
    bs = batch_spec(mesh, shape.global_batch)
    specs = {k: P((bs,) + (None,) * (v.ndim - 1))
             for k, v in structs.items()}
    return structs, specs


def mesh_prefill_batch_specs(cfg: ArchConfig, shape: ShapeConfig, mesh,
                             device="meta"):
    """:func:`mesh_train_batch_specs` without ``labels``."""
    structs, specs = mesh_train_batch_specs(cfg, shape, mesh, device)
    del structs["labels"], specs["labels"]
    return structs, specs


def mesh_decode_input_specs(cfg: ArchConfig, shape: ShapeConfig, mesh,
                            device="meta"):
    """(one token a slot (B,) int32, its spec)."""
    return (decode_input_specs(cfg, shape, device),
            P((batch_spec(mesh, shape.global_batch),)))


def state_spec(cfg: ArchConfig, name: str, shape, b: int, seq_len: int,
               mesh) -> P:
    """The spec of the decode state's leaf ``name`` of ``shape`` for a
    batch of ``b`` and a cache of ``seq_len``: ``spec_for`` of the JAX
    module, name tests and all (any leaf whose name holds a "k", "v" or
    "S" is a cache candidate: ``mamba_conv`` too, whose four dims keep it
    out)."""
    bs = batch_spec(mesh, b)
    seq_shard = bs is None and _div(seq_len, mesh, ("data",))
    nd = len(shape)
    if nd == 1:                                       # pos
        return P((None,))
    axes = [None] * nd
    if nd >= 2 and shape[1] == b and bs is not None:
        axes[1] = bs
    if "k" in name or "v" in name or "S" in name:
        if nd == 5 and shape[3] == cfg.n_kv_heads and _div(
                shape[3], mesh, ("model",)):
            axes[3] = "model"                         # KV heads
        elif nd == 5 and _div(shape[4], mesh, ("model",)):
            axes[4] = "model"                         # the head dimension
        if nd == 5 and seq_shard and shape[2] == seq_len:
            axes[2] = "data"                          # the sequence
    if "mamba_h" in name and nd == 5 and _div(shape[2], mesh, ("model",)):
        axes[2] = "model"
    return P(axes)


def mesh_decode_state_specs(cfg: ArchConfig, shape: ShapeConfig, mesh,
                            model=None):
    """(:func:`decode_state_specs`, the same NamedTuple of specs, by
    :func:`state_spec`)."""
    state = decode_state_specs(cfg, shape, model)
    specs = type(state)(*[
        state_spec(cfg, name, tuple(leaf.shape), shape.global_batch,
                   shape.seq_len, mesh)
        for name, leaf in zip(state._fields, state)])
    return state, specs


def mesh_coord(mesh) -> Dict[str, int]:
    """{axis: this rank's index} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def layout_of(spec, shape, mesh, coord: Dict[str, int]) -> TensorLayout:
    """The :class:`TensorLayout` of a whole tensor of ``shape`` with
    ``spec`` on ``mesh``, seen from ``coord``."""
    sizes = axis_sizes(mesh)
    return TensorLayout(spec, shape, sizes,
                        {a: coord.get(a, 0) for a in sizes})


def local(tree, specs, mesh, coord: Dict[str, int]):
    """The rank's part of each whole stand-in of ``tree`` (meta: a new
    stand-in of the local shape; elsewhere the shard, copied)."""
    def part(t, spec):
        lay = layout_of(spec, tuple(t.shape), mesh, coord)
        if t.device.type == "meta":
            return t.new_empty(lay.local_shape)
        return lay.shard(t).clone()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[part(t, s) for t, s in zip(tree, specs)])
    if isinstance(tree, dict):
        return {k: part(v, specs[k]) for k, v in tree.items()}
    return part(tree, specs)


"""Input stand-ins for every (arch x shape) cell on one card: the port of
``repro.launch.specs`` without shardings.

JAX describes a cell's inputs as ``ShapeDtypeStruct`` s; here they are
tensors on the ``meta`` device by default (names, shapes and dtypes, no
memory), or empty tensors on another device for :func:`draw` to fill.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .._tree import tree_map
from ..configs.base import ArchConfig, ShapeConfig
from ..models import build_model
from ..models.layers import cdtype


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

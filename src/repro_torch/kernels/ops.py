"""Dispatch of the kernels by device, and their launch counts.

A CPU tensor takes the kernel's plain PyTorch version.  A CUDA tensor
launches the hand-written kernel or raises: no failure to build or launch
falls back to the plain version or to the CPU.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import bincount as _bincount
from . import bitonic_sort as _bitonic
from . import flash_attention as _flash


def _route(t: torch.Tensor, what: str) -> bool:
    """True for the kernel, False for the plain version."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel for device {t.device}")


def bincount_tiles(tiles: torch.Tensor, n_buckets: int):
    """Fused (counts, cross-tile exclusive prefix, in-tile bucket offsets)
    over (T, tile_n) ids — the radix shuffle's counting phase."""
    if _route(tiles, "bincount_tiles"):
        return _bincount.bincount_tiles_cuda(tiles, n_buckets)
    return _bincount.bincount_tiles_plain(tiles, n_buckets)


def bitonic_sort(keys: torch.Tensor, values: torch.Tensor):
    """Each row of (rows, n) sorted ascending by key, values moved along."""
    if _route(keys, "bitonic_sort"):
        return _bitonic.bitonic_sort_cuda(keys, values)
    return _bitonic.bitonic_sort_plain(keys, values)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Softmax attention of q (b, hq, s, d) over k, v (b, hkv, s, d), hq a
    multiple of hkv (GQA); returns (b, hq, s, d) in q's dtype."""
    if _route(q, "flash_attention"):
        return _flash.flash_attention_cuda(q, k, v, causal)
    return _flash.flash_attention_plain(q, k, v, causal)


def launches() -> Dict[str, int]:
    """CUDA launches of each kernel since the last :func:`reset_launches`."""
    return {"bincount_tiles": _bincount.launches,
            "bitonic_sort": _bitonic.launches,
            "flash_attention": _flash.launches}


def reset_launches() -> None:
    _bincount.launches = 0
    _bitonic.launches = 0
    _flash.launches = 0

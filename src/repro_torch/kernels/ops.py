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
from . import prefix_scan as _prefix
from . import ssm_scan as _ssm


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


def ssm_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + x_t along axis 1 of (batch, seq, d), float32
    carry, h in x's dtype.

    Forward only on the card: the JAX entry point is differentiable through
    a custom VJP whose backward kernel comes with the training slice, so a
    CUDA call that would need a gradient raises instead of returning a
    result that silently carries none.  On the CPU the plain version is
    differentiable by autograd."""
    if _route(x, "ssm_scan"):
        if torch.is_grad_enabled() and (a.requires_grad or x.requires_grad):
            raise NotImplementedError(
                "ssm_scan on CUDA is forward only: its backward kernel comes "
                "with the training slice of the port; call it under "
                "torch.no_grad() or on inputs that do not require grad")
        return _ssm.ssm_scan_cuda(a, x)
    return _ssm.ssm_scan_plain(a, x)


def prefix_scan(x: torch.Tensor, *, exclusive: bool = False) -> torch.Tensor:
    """Cumulative sum along the last axis of (rows, n), int32 or float32,
    in x's dtype (int32 wraps)."""
    if _route(x, "prefix_scan"):
        return _prefix.prefix_scan_cuda(x, exclusive)
    return _prefix.prefix_scan_plain(x, exclusive)


def bincount(ids: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """(n_buckets,) int32 histogram of (n,) int32 ids; ids outside
    [0, n_buckets) are ignored."""
    if _route(ids, "bincount"):
        return _bincount.bincount_cuda(ids, n_buckets)
    return _bincount.bincount_plain(ids, n_buckets)


def launches() -> Dict[str, int]:
    """CUDA launches of each kernel since the last :func:`reset_launches`,
    and of each route of the kernels that have two, as ``kernel.route``."""
    return {**_bincount.launches,
            "bitonic_sort": _bitonic.launches,
            "flash_attention": _flash.launches,
            "ssm_scan": _ssm.launches,
            "prefix_scan": _prefix.launches,
            **{f"bincount_tiles.{r}": n
               for r, n in _bincount.route_launches.items()},
            **{f"flash_attention.{r}": n
               for r, n in _flash.route_launches.items()}}


def reset_launches() -> None:
    _bincount.launches.update(bincount_tiles=0, bincount=0)
    _bincount.route_launches.update({"single_pass": 0, "global": 0})
    _bitonic.launches = 0
    _flash.launches = 0
    _flash.route_launches.update(wgmma=0, cuda_core=0)
    _ssm.launches = 0
    _prefix.launches = 0

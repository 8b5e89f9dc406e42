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
from . import chain as _chain
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
    over (T, tile_n) ids — the radix shuffle's counting phase — or over
    (B, T, tile_n) ids of B queries, the prefix restarting at each query."""
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
    multiple of hkv (GQA); returns (b, hq, s, d) in q's dtype.

    Forward only on the card: neither package has a backward for the flash
    kernel (a gradient through the JAX Pallas kernel fails too), so a CUDA
    call that would need a gradient raises instead of returning a result
    that carries none.  Train with ``attn_impl="xla"``, as the JAX package
    does.  On the CPU the plain version is differentiable by autograd."""
    if _route(q, "flash_attention"):
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            raise NotImplementedError(
                "flash_attention on CUDA has no backward kernel (nor has "
                "the JAX package's Pallas kernel): train with "
                "attn_impl='xla', or call it under torch.no_grad()")
        return _flash.flash_attention_cuda(q, k, v, causal)
    return _flash.flash_attention_plain(q, k, v, causal)


def ssm_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + x_t along axis 1 of (batch, seq, d), float32
    carry, h in x's dtype.

    Differentiable on both routes, as the JAX entry point is through its
    custom VJP: on the card the forward and the backward are the two
    kernels of ``csrc/ssm_scan.cu`` (:class:`~.ssm_scan.SsmScan`); on the
    CPU the plain version is differentiated by autograd."""
    if _route(x, "ssm_scan"):
        return _ssm.SsmScan.apply(a, x)
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


def monotone_chain(pts: torch.Tensor, counts: torch.Tensor):
    """Andrew's monotone chain over (V, L, 2) float32 lex-sorted,
    deduplicated runs whose live points are a prefix of ``counts`` (V,)
    int32 slots: (hulls (V, L, 2) CCW from each lex-min with zero padding,
    vertex counts (V,) int32)."""
    if _route(pts, "monotone_chain"):
        return _chain.monotone_chain_cuda(pts, counts)
    return _chain.monotone_chain_plain(pts, counts)


def launches() -> Dict[str, int]:
    """CUDA launches of each kernel since the last :func:`reset_launches`,
    and of each route of the kernels that have two, as ``kernel.route``.
    ``ssm_scan`` counts the forward kernel and ``ssm_scan.bwd`` the
    backward kernel apart from it."""
    return {**_bincount.launches,
            "bitonic_sort": _bitonic.launches,
            "flash_attention": _flash.launches,
            "ssm_scan": _ssm.launches,
            "ssm_scan.bwd": _ssm.bwd_launches,
            "prefix_scan": _prefix.launches,
            "monotone_chain": _chain.launches,
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
    _ssm.bwd_launches = 0
    _prefix.launches = 0
    _chain.launches = 0

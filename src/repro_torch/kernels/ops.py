"""Dispatch of the kernels by device, their launch counts, and the hook a
counter of work reads.

A CPU tensor takes the kernel's plain PyTorch version.  A CUDA tensor
launches the hand-written kernel or raises: no failure to build or launch
falls back to the plain version or to the CPU.  A meta tensor takes the
kernel's meta route, which allocates what the CUDA wrapper allocates and
computes nothing (for :mod:`repro_torch.launch.dryrun`); it never reaches
a plain version.  Any other device raises.

Every call, on any route, reports its kernel's name and work (flops and
bytes from its shapes, the ``*_work`` function beside the kernel) to each
active counter: a ``TorchDispatchMode`` on the dispatch stack with a
``kernel_call(name, flops, nbytes)`` context manager, which
:func:`counted` enters around the call.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from . import bincount as _bincount
from . import bitonic_sort as _bitonic
from . import chain as _chain
from . import flash_attention as _flash
from . import prefix_scan as _prefix
from . import ssm_scan as _ssm

_ROUTES = ("cuda", "cpu", "meta")


def _route(t: torch.Tensor, what: str) -> str:
    """The route of ``t``'s device: ``"cuda"`` (the kernel), ``"cpu"``
    (the plain version) or ``"meta"`` (the meta route)."""
    if t.device.type in _ROUTES:
        return t.device.type
    raise ValueError(f"{what}: no kernel for device {t.device}")


def counted(name: str, work: Callable[[], Tuple[int, int]]):
    """A context manager around one call of kernel ``name``: each active
    counter takes ``work()`` (flops, bytes) and keeps the aten ops inside
    out of its own counts.  ``work`` is called only when a counter is
    active."""
    modes = [m for m in _get_current_dispatch_mode_stack()
             if hasattr(m, "kernel_call")]
    if not modes:
        return contextlib.nullcontext()
    flops, nbytes = work()
    stack = contextlib.ExitStack()
    for m in modes:
        stack.enter_context(m.kernel_call(name, flops, nbytes))
    return stack


def bincount_tiles(tiles: torch.Tensor, n_buckets: int):
    """Fused (counts, cross-tile exclusive prefix, in-tile bucket offsets)
    over (T, tile_n) ids — the radix shuffle's counting phase — or over
    (B, T, tile_n) ids of B queries, the prefix restarting at each query."""
    route = _route(tiles, "bincount_tiles")
    fn = {"cuda": _bincount.bincount_tiles_cuda,
          "cpu": _bincount.bincount_tiles_plain,
          "meta": _bincount.bincount_tiles_meta}[route]
    with counted("bincount_tiles", lambda: _bincount.bincount_tiles_work(
            math.prod(tiles.shape[:-1]), tiles.shape[-1], n_buckets)):
        return fn(tiles, n_buckets)


def bitonic_sort(keys: torch.Tensor, values: torch.Tensor):
    """Each row of (rows, n) sorted ascending by key, values moved along."""
    route = _route(keys, "bitonic_sort")
    fn = {"cuda": _bitonic.bitonic_sort_cuda,
          "cpu": _bitonic.bitonic_sort_plain,
          "meta": _bitonic.bitonic_sort_meta}[route]
    _bitonic._check_pair(keys, values)
    with counted("bitonic_sort", lambda: _bitonic.bitonic_sort_work(
            *keys.shape, keys.dtype, values.dtype)):
        return fn(keys, values)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Softmax attention of q (b, hq, s, d) over k, v (b, hkv, s, d), hq a
    multiple of hkv (GQA); returns (b, hq, s, d) in q's dtype.

    Forward only on the card: neither package has a backward for the flash
    kernel (a gradient through the JAX Pallas kernel fails too), so a CUDA
    (or meta) call that would need a gradient raises instead of returning
    a result that carries none.  Train with ``attn_impl="xla"``, as the JAX
    package does.  On the CPU the plain version is differentiable by
    autograd."""
    route = _route(q, "flash_attention")
    if route != "cpu" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention on CUDA has no backward kernel (nor has "
            "the JAX package's Pallas kernel): train with "
            "attn_impl='xla', or call it under torch.no_grad()")
    fn = {"cuda": _flash.flash_attention_cuda,
          "cpu": _flash.flash_attention_plain,
          "meta": _flash.flash_attention_meta}[route]
    _flash._check(q, k, v)
    with counted("flash_attention", lambda: _flash.flash_attention_work(
            q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
            q.shape[3], causal, q.dtype)):
        return fn(q, k, v, causal)


def ssm_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + x_t along axis 1 of (batch, seq, d), float32
    carry, h in x's dtype.

    Differentiable on every route, as the JAX entry point is through its
    custom VJP: :class:`~.ssm_scan.SsmScan` runs the route's forward and
    its reversed scan as the backward; on the card they are the two
    kernels of ``csrc/ssm_scan.cu``, on the CPU the plain versions."""
    _route(x, "ssm_scan")
    return _ssm.SsmScan.apply(a, x)


def prefix_scan(x: torch.Tensor, *, exclusive: bool = False) -> torch.Tensor:
    """Cumulative sum along the last axis of (rows, n), int32 or float32,
    in x's dtype (int32 wraps)."""
    route = _route(x, "prefix_scan")
    fn = {"cuda": _prefix.prefix_scan_cuda, "cpu": _prefix.prefix_scan_plain,
          "meta": _prefix.prefix_scan_meta}[route]
    _prefix._check(x)
    with counted("prefix_scan", lambda: _prefix.prefix_scan_work(
            *x.shape, x.dtype)):
        return fn(x, exclusive)


def bincount(ids: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """(n_buckets,) int32 histogram of (n,) int32 ids; ids outside
    [0, n_buckets) are ignored."""
    route = _route(ids, "bincount")
    fn = {"cuda": _bincount.bincount_cuda, "cpu": _bincount.bincount_plain,
          "meta": _bincount.bincount_meta}[route]
    with counted("bincount", lambda: _bincount.bincount_work(
            ids.numel(), n_buckets)):
        return fn(ids, n_buckets)


def monotone_chain(pts: torch.Tensor, counts: torch.Tensor):
    """Andrew's monotone chain over (V, L, 2) float32 lex-sorted,
    deduplicated runs whose live points are a prefix of ``counts`` (V,)
    int32 slots: (hulls (V, L, 2) CCW from each lex-min with zero padding,
    vertex counts (V,) int32).  A counter takes the shape's work with
    every slot live and no point kept, 4 L turn tests a run: the tests
    depend on the data, which the counter does not read."""
    route = _route(pts, "monotone_chain")
    fn = {"cuda": _chain.monotone_chain_cuda,
          "cpu": _chain.monotone_chain_plain,
          "meta": _chain.monotone_chain_meta}[route]
    _chain._check(pts, counts)
    with counted("monotone_chain", lambda: _chain.monotone_chain_work(
            pts.shape[0], pts.shape[1], pts.shape[0] * pts.shape[1],
            4 * pts.shape[0] * pts.shape[1])):
        return fn(pts, counts)


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

"""Bucket histograms: the per-tile histogram with its two exclusive scans,
the counting phase of the multi-tile radix shuffle
(:mod:`repro_torch.core.kshuffle`), and one global histogram.

``bincount_tiles(tiles, V)`` takes a (T, tile_n) int32 id matrix and returns
three (T, V) int32 matrices:

- ``counts[t, b]`` — occurrences of b in tile t;
- ``tile_prefix[t, b]`` — occurrences of b in tiles 0..t-1;
- ``bucket_offsets[t, b]`` — occurrences of buckets 0..b-1 in tile t.

``bincount(ids, V)`` takes an (n,) int32 id vector and returns the (V,)
int32 histogram, reached through :func:`repro_torch.kernels.ops.bincount`.

Ids < 0 or >= V are ignored by both.  Each function has two implementations
here: ``*_cuda``, which launches the hand-written kernel of
``csrc/bincount_tiles.cu`` or ``csrc/bincount.cu``, and ``*_plain``, plain
PyTorch for the CPU and as the kernel's yardstick on the card.
:mod:`repro_torch.kernels.ops` picks one by device.

``bincount_tiles`` has two routes on the card: ``single_pass`` for V up to
48 Ki buckets and fewer than 2^30 ids (one launch; blocks of
:func:`group_tiles` tiles carry P across blocks by decoupled look-back) and
``global`` otherwise (global atomics and a column scan over C).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build

#: launches of each CUDA kernel since the last reset (ops.reset_launches)
launches = {"bincount_tiles": 0, "bincount": 0}
#: the bincount_tiles launches by route
route_launches = {"single_pass": 0, "global": 0}

Tables = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _check(tiles: torch.Tensor, n_buckets: int) -> None:
    if tiles.ndim != 2:
        raise ValueError("bincount_tiles expects (T, tile_n)")
    if n_buckets < 0:
        raise ValueError(f"n_buckets must be >= 0, got {n_buckets}")


def bincount_tiles_plain(tiles: torch.Tensor, n_buckets: int) -> Tables:
    """Plain PyTorch: one bincount over tile-offset ids, then two cumsums."""
    _check(tiles, n_buckets)
    T, tile_n = tiles.shape
    V = int(n_buckets)
    ok = (tiles >= 0) & (tiles < V)
    # ignored ids land in a sentinel bucket V, cut off after counting
    row_base = torch.arange(T, device=tiles.device).unsqueeze(1) * (V + 1)
    ids = torch.where(ok, tiles.long(), V) + row_base
    C = torch.bincount(ids.reshape(-1), minlength=T * (V + 1))
    C = C.view(T, V + 1)[:, :V].to(torch.int32)
    P = torch.cumsum(C, 0, dtype=torch.int32) - C
    F = torch.cumsum(C, 1, dtype=torch.int32) - C
    return C.contiguous(), P, F


def bincount_tiles_cuda(tiles: torch.Tensor, n_buckets: int) -> Tables:
    """Launch ``csrc/bincount_tiles.cu`` on a CUDA tensor; raises on any
    failure to build or launch."""
    _check(tiles, n_buckets)
    if tiles.device.type != "cuda" or tiles.dtype != torch.int32:
        raise ValueError("bincount_tiles_cuda takes a CUDA int32 tensor, got "
                         f"{tiles.dtype} on {tiles.device}")
    tiles = tiles.contiguous()
    T, tile_n = tiles.shape
    V = int(n_buckets)
    if T == 0 or V == 0:
        return tuple(torch.zeros((T, V), dtype=torch.int32, device=tiles.device)
                     for _ in range(3))
    C, P, F = (torch.empty((T, V), dtype=torch.int32, device=tiles.device)
               for _ in range(3))
    lib = _build.library()
    scratch = torch.empty(lib.repro_bincount_tiles_scratch_bytes(T, tile_n, V),
                          dtype=torch.uint8, device=tiles.device)
    stream = torch.cuda.current_stream(tiles.device).cuda_stream
    err = lib.repro_bincount_tiles(tiles.data_ptr(), T, tile_n, V,
                                   C.data_ptr(), P.data_ptr(), F.data_ptr(),
                                   scratch.data_ptr(), stream)
    _build.check(err, "bincount_tiles")
    launches["bincount_tiles"] += 1
    route_launches["single_pass" if group_tiles(T, tile_n, V)
                   else "global"] += 1
    return C, P, F


def group_tiles(T: int, tile_n: int, n_buckets: int) -> int:
    """Tiles one block of the single-pass route counts for a (T, tile_n)
    id matrix over ``n_buckets`` (8 at 2048), or 0 where the kernel takes
    the global route; asks the built library."""
    return int(_build.library().repro_bincount_tiles_group(T, tile_n,
                                                          n_buckets))


def _check_ids(ids: torch.Tensor, n_buckets: int) -> None:
    if ids.ndim != 1:
        raise ValueError("bincount expects (n,)")
    if n_buckets < 0:
        raise ValueError(f"n_buckets must be >= 0, got {n_buckets}")


def bincount_plain(ids: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Plain PyTorch: ignored ids go to a sentinel bucket V, cut off after
    one ``torch.bincount``."""
    _check_ids(ids, n_buckets)
    V = int(n_buckets)
    ok = (ids >= 0) & (ids < V)
    counts = torch.bincount(torch.where(ok, ids.long(), V), minlength=V + 1)
    return counts[:V].to(torch.int32)


def bincount_cuda(ids: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Launch ``csrc/bincount.cu`` on a CUDA tensor; raises on any failure
    to build or launch."""
    _check_ids(ids, n_buckets)
    if ids.device.type != "cuda" or ids.dtype != torch.int32:
        raise ValueError("bincount_cuda takes a CUDA int32 tensor, got "
                         f"{ids.dtype} on {ids.device}")
    V = int(n_buckets)
    if ids.numel() == 0 or V == 0:
        return torch.zeros((V,), dtype=torch.int32, device=ids.device)
    ids = ids.contiguous()
    out = torch.empty((V,), dtype=torch.int32, device=ids.device)
    stream = torch.cuda.current_stream(ids.device).cuda_stream
    err = _build.library().repro_bincount(ids.data_ptr(), ids.numel(), V,
                                          out.data_ptr(), stream)
    _build.check(err, "bincount")
    launches["bincount"] += 1
    return out

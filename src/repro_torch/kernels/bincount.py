"""Bucket histograms: the per-tile histogram with its two exclusive scans,
the counting phase of the multi-tile radix shuffle
(:mod:`repro_torch.core.kshuffle`), and one global histogram.

``bincount_tiles(tiles, V)`` takes a (T, tile_n) int32 id matrix and returns
three (T, V) int32 matrices:

- ``counts[t, b]`` — occurrences of b in tile t;
- ``tile_prefix[t, b]`` — occurrences of b in tiles 0..t-1;
- ``bucket_offsets[t, b]`` — occurrences of buckets 0..b-1 in tile t.

A (B, T, tile_n) array is B independent queries, as the JAX kernel is under
``jax.vmap``: the tables are (B, T, V) and ``tile_prefix`` restarts at each
query.

``bincount(ids, V)`` takes an (n,) int32 id vector and returns the (V,)
int32 histogram, reached through :func:`repro_torch.kernels.ops.bincount`.

Ids < 0 or >= V are ignored by both.  Each function has two implementations
here: ``*_cuda``, which launches the hand-written kernel of
``csrc/bincount_tiles.cu`` or ``csrc/bincount.cu``, and ``*_plain``, plain
PyTorch for the CPU and as the kernel's yardstick on the card; ``*_meta``
allocates the outputs on the meta device, for a dry run, and ``*_work``
gives a call's operations and bytes.
:mod:`repro_torch.kernels.ops` picks one by device.

``bincount_tiles`` has two routes on the card: ``single_pass`` for V up to
48 Ki buckets and fewer than 2^30 ids a query (one launch; blocks of
:func:`group_tiles` tiles carry P across blocks by decoupled look-back, each
query's first group starting it afresh) and ``global`` otherwise (global
atomics and a column scan over each query's C).  Either way one launch
covers the whole batch.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from . import _build

#: launches of each CUDA kernel since the last reset (ops.reset_launches)
launches = {"bincount_tiles": 0, "bincount": 0}
#: the bincount_tiles launches by route
route_launches = {"single_pass": 0, "global": 0}

Tables = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _check(tiles: torch.Tensor, n_buckets: int) -> None:
    if tiles.ndim not in (2, 3):
        raise ValueError("bincount_tiles expects (T, tile_n) or "
                         "(B, T, tile_n)")
    if n_buckets < 0:
        raise ValueError(f"n_buckets must be >= 0, got {n_buckets}")


def bincount_tiles_plain(tiles: torch.Tensor, n_buckets: int) -> Tables:
    """Plain PyTorch: one bincount over ids offset by their row (query b,
    tile t) by ``(b T + t) (V + 1)``, then two cumsums, the cross-tile one
    within each query."""
    _check(tiles, n_buckets)
    *lead, T, tile_n = tiles.shape
    V = int(n_buckets)
    R = math.prod(lead) * T                   # rows, over all queries
    ok = (tiles >= 0) & (tiles < V)
    # ignored ids land in a sentinel bucket V, cut off after counting
    row_base = (torch.arange(R, device=tiles.device).view(*lead, T, 1)
                * (V + 1))
    ids = torch.where(ok, tiles.long(), V) + row_base
    C = torch.bincount(ids.reshape(-1), minlength=R * (V + 1))
    C = C.view(*lead, T, V + 1)[..., :V].to(torch.int32)
    P = torch.cumsum(C, -2, dtype=torch.int32) - C
    F = torch.cumsum(C, -1, dtype=torch.int32) - C
    return C.contiguous(), P, F


def bincount_tiles_work(rows: int, tile_n: int, n_buckets: int
                        ) -> Tuple[int, int]:
    """(operations, bytes) of one call over ``rows`` tiles in all (T, or
    B T for a batch) of tile_n ids into n_buckets: the ids read once, C, P
    and F written once; one count an id."""
    return rows * tile_n, rows * tile_n * 4 + 3 * rows * n_buckets * 4


def bincount_tiles_cuda(tiles: torch.Tensor, n_buckets: int) -> Tables:
    """Launch ``csrc/bincount_tiles.cu`` on a CUDA tensor, once for the
    whole batch; raises on any failure to build or launch."""
    return _tiles(tiles, n_buckets, "cuda")


def bincount_tiles_meta(tiles: torch.Tensor, n_buckets: int) -> Tables:
    """The meta route: checks the ids and allocates C, P, F as
    :func:`bincount_tiles_cuda` does on a meta tensor; the scratch, which
    the built library sizes, is left out."""
    return _tiles(tiles, n_buckets, "meta")


def _tiles(tiles, n_buckets: int, device_type: str) -> Tables:
    _check(tiles, n_buckets)
    if tiles.device.type != device_type or tiles.dtype != torch.int32:
        raise ValueError(f"bincount_tiles_{device_type} takes a "
                         f"{device_type.upper()} int32 tensor, got "
                         f"{tiles.dtype} on {tiles.device}")
    tiles = tiles.contiguous()
    *lead, T, tile_n = tiles.shape
    B = lead[0] if lead else 1
    V = int(n_buckets)
    shape = (*lead, T, V)
    if B == 0 or T == 0 or V == 0:
        return tuple(torch.zeros(shape, dtype=torch.int32, device=tiles.device)
                     for _ in range(3))
    C, P, F = (torch.empty(shape, dtype=torch.int32, device=tiles.device)
               for _ in range(3))
    if device_type == "meta":
        return C, P, F
    lib = _build.library()
    scratch = torch.empty(
        lib.repro_bincount_tiles_scratch_bytes(B, T, tile_n, V),
        dtype=torch.uint8, device=tiles.device)
    stream = torch.cuda.current_stream(tiles.device).cuda_stream
    err = lib.repro_bincount_tiles(tiles.data_ptr(), B, T, tile_n, V,
                                   C.data_ptr(), P.data_ptr(), F.data_ptr(),
                                   scratch.data_ptr(), stream)
    _build.check(err, "bincount_tiles")
    launches["bincount_tiles"] += 1
    route_launches["single_pass" if group_tiles(T, tile_n, V)
                   else "global"] += 1
    return C, P, F


def group_tiles(T: int, tile_n: int, n_buckets: int, B: int = 1) -> int:
    """Tiles one block of the single-pass route counts for a query's
    (T, tile_n) id matrix over ``n_buckets`` (8 at 2048), or 0 where the
    kernel takes the global route; asks the built library.  The limits hold
    per query, so the batch ``B`` changes nothing."""
    return int(_build.library().repro_bincount_tiles_group(B, T, tile_n,
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


def bincount_work(n: int, n_buckets: int) -> Tuple[int, int]:
    """(operations, bytes) of one call: the ids read once, the histogram
    written once; one count an id."""
    return n, n * 4 + n_buckets * 4


def bincount_cuda(ids: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Launch ``csrc/bincount.cu`` on a CUDA tensor; raises on any failure
    to build or launch."""
    return _bincount(ids, n_buckets, "cuda")


def bincount_meta(ids: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """The meta route: checks the ids and allocates the histogram as
    :func:`bincount_cuda` does on a meta tensor."""
    return _bincount(ids, n_buckets, "meta")


def _bincount(ids, n_buckets: int, device_type: str) -> torch.Tensor:
    _check_ids(ids, n_buckets)
    if ids.device.type != device_type or ids.dtype != torch.int32:
        raise ValueError(f"bincount_{device_type} takes a "
                         f"{device_type.upper()} int32 tensor, got "
                         f"{ids.dtype} on {ids.device}")
    V = int(n_buckets)
    if ids.numel() == 0 or V == 0:
        return torch.zeros((V,), dtype=torch.int32, device=ids.device)
    ids = ids.contiguous()
    out = torch.empty((V,), dtype=torch.int32, device=ids.device)
    if device_type == "meta":
        return out
    stream = torch.cuda.current_stream(ids.device).cuda_stream
    err = _build.library().repro_bincount(ids.data_ptr(), ids.numel(), V,
                                          out.data_ptr(), stream)
    _build.check(err, "bincount")
    launches["bincount"] += 1
    return out


# The JAX module's public names.  Each is the device dispatch of
# :mod:`repro_torch.kernels.ops` (imported at the call: ``ops`` imports this
# module), so a launch is counted once, on the one path.
def bincount(ids: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """(n_buckets,) int32 histogram of (n,) int32 ids, ids outside
    [0, n_buckets) ignored: :func:`repro_torch.kernels.ops.bincount`.  The
    JAX function's ``block_t`` tiling keyword changes no result and is
    left out."""
    from . import ops
    return ops.bincount(ids, n_buckets)


def bincount_tiles(tiles: torch.Tensor, n_buckets: int) -> Tables:
    """(counts, tile_prefix, bucket_offsets) of (T, tile_n) or (B, T,
    tile_n) int32 ids: :func:`repro_torch.kernels.ops.bincount_tiles`."""
    from . import ops
    return ops.bincount_tiles(tiles, n_buckets)

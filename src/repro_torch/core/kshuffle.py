"""Kernel-backed Shuffle step: a multi-tile radix route on the hand-written
CUDA kernels of :mod:`repro_torch.kernels`.

Theorem 4.2's queue discipline makes the shuffle a two-phase "invisible
funnel": first send the *counts* (how many items target each reducer), then
route items to reserved slots.  :func:`kernel_shuffle` is that dataflow:

    dests, tiled (B, T, tile) ──► bincount_tiles ──► C  per-tile counts
                                                 ──► P  cross-tile excl. prefix
                                                 ──► F  in-tile bucket offsets
    segmented keys dest·tile + local_src ──► bitonic_sort (B·T row sorts)
    rank = P[tile, dest] + (sorted position − F[tile, dest])   global FIFO
    rank-addressed scatter ──► (V, capacity) mailbox slots

The composite key is segmented per tile — ``dest * tile + local_src`` with
local_src < tile — so it stays int32 and unique within its row.  The result
is bit-identical to the dense :func:`repro_torch.core.mrmodel.shuffle`: same
mailbox payload and validity, same :class:`RoundStats`, same FIFO order.
B queries shuffle together (:func:`kernel_shuffle_batch`, B = 1 for one
query): one ``bincount_tiles`` and one ``bitonic_sort`` launch for the
batch.

On a CUDA tensor the two kernels launch; on a CPU tensor their plain
PyTorch versions run (:mod:`repro_torch.kernels.ops`).  The guards and
budgets are those of the JAX package's ``repro.core.kshuffle``, unchanged,
so both packages route every call the same way.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F_

from ..kernels import ops as _kops
from .costmodel import RoundStats
from .._tree import tree_map
from .mrmodel import Mailbox, Payload, materialize_mailbox, unbatch_shuffle

_INT32_MAX = 2**31 - 1
#: default within-tile sort width (one bitonic network per tile)
_TILE_N = 4096
#: below this derived tile width the per-tile sort degenerates — bail dense
_MIN_TILE_N = 8
#: budget for tile * (n_nodes+1); tiles shrink to honor it
_ONEHOT_BUDGET = 1 << 24
#: total-element budget for each (T, n_nodes+1) count matrix
_COUNTS_BUDGET = 1 << 25


class RouteLog:
    """Host-side counters of an engine's kernel-vs-dense routing decision
    (``LocalEngine`` / ``ShardedEngine`` with ``shuffle_impl="kernel"``),
    one increment per shuffle call, so tests and the chip smoke can assert
    the kernel path was taken (``dense == 0``).  Each kernel-capable engine
    owns its own instance.

    ``overlapped`` counts the rounds a ``ShardedEngine`` issued through its
    overlapped schedule: a scheduling counter, not a routing one, so
    :meth:`snapshot` (the kernel-vs-dense pair) leaves it out."""

    __slots__ = ("kernel", "dense", "overlapped")

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.kernel = 0
        self.dense = 0
        self.overlapped = 0

    def snapshot(self) -> Tuple[int, int]:
        return (self.kernel, self.dense)


def _tile_width(n_nodes: int, tile_n: Optional[int] = None) -> int:
    """Within-tile sort width for a shuffle into ``n_nodes`` buckets: the
    largest power of two within ``_TILE_N``, ``_ONEHOT_BUDGET // (V+1)`` and
    the int32 key space ``(V+1) * tile``.  An explicit ``tile_n`` overrides
    the derivation."""
    if tile_n is not None:
        if tile_n < 1:
            raise ValueError(f"tile_n must be >= 1, got {tile_n}")
        return tile_n
    limit = min(_TILE_N, _ONEHOT_BUDGET // (n_nodes + 1),
                _INT32_MAX // (n_nodes + 1))
    t = 1
    while t * 2 <= limit:
        t *= 2
    return t


def kernel_fits(n: int, n_nodes: int, tile_n: Optional[int] = None) -> bool:
    """Whether a shuffle of ``n`` flattened items into ``n_nodes`` nodes fits
    the kernel path's two guards: the derived tile width stays >=
    ``_MIN_TILE_N`` (and the segmented keys within int32), and the (T,
    n_nodes+1) count matrices fit ``_COUNTS_BUDGET`` elements."""
    tile = _tile_width(n_nodes, tile_n)
    if tile < _MIN_TILE_N and tile_n is None:
        return False
    if (n_nodes + 1) * tile > _INT32_MAX:   # explicit tile_n past key space
        return False
    n_tiles = -(-n // tile) if n else 1
    return n_tiles * (n_nodes + 1) <= _COUNTS_BUDGET


def _check_fits(n: int, n_nodes: int, tile_n: Optional[int]) -> None:
    tile = _tile_width(n_nodes, tile_n)
    if ((tile < _MIN_TILE_N and tile_n is None)
            or (n_nodes + 1) * tile > _INT32_MAX):
        raise ValueError(
            f"kernel_shuffle: n_nodes={n_nodes} shrinks the per-tile "
            f"segmented key space dest*tile+src below tile={tile} < "
            f"{_MIN_TILE_N} (or past int32); use the dense shuffle "
            f"(LocalEngine(shuffle_impl='dense')) for this node count")
    n_tiles = -(-n // tile) if n else 1
    if n_tiles * (n_nodes + 1) > _COUNTS_BUDGET:
        raise ValueError(
            f"kernel_shuffle: tile-count matrix {n_tiles}x{n_nodes + 1} "
            f"exceeds the counts budget ({_COUNTS_BUDGET}); use the dense "
            f"shuffle (LocalEngine(shuffle_impl='dense')) for this size")


def kernel_shuffle_batch(dests: torch.Tensor, payload: Payload,
                         n_nodes: int, capacity: int, *,
                         tile_n: Optional[int] = None
                         ) -> Tuple[Mailbox, RoundStats]:
    """Kernel-composed Shuffle of B queries at once: ``dests`` (B, ...) and
    payload leaves (B, ...) in, a (B, V, capacity) mailbox and (B,) stats
    out, each row what :func:`kernel_shuffle` gives for that query alone.

    The guards are checked on one query's (n, V), as the JAX package
    checks them under ``vmap``.  Each query is tiled on its own, so the
    whole batch is one (B, T, tile) ``bincount_tiles`` call, whose
    cross-tile prefix restarts at each query, and one ``bitonic_sort`` over
    the B T rows."""
    B = dests.shape[0]
    flat_dest = dests.reshape(B, -1).to(torch.int32)
    n = flat_dest.shape[1]
    _check_fits(n, n_nodes, tile_n)
    valid = flat_dest >= 0
    dev = flat_dest.device

    if n == 0:
        counts = torch.zeros((B, n_nodes), dtype=torch.int32, device=dev)
        rank = torch.zeros((B, 0), dtype=torch.int32, device=dev)
    else:
        tile = _tile_width(n_nodes, tile_n)
        n_tiles = -(-n // tile)
        # Source-order tiling of each query; the tail pads with the "no
        # item" sentinel.
        dtile = F_.pad(flat_dest, (0, n_tiles * tile - n),
                       value=-1).view(B, n_tiles, tile)
        # Phase 1 — counts, fused: per-tile fan-in C, cross-tile exclusive
        # prefix P (within each query) and in-tile bucket offsets F, one
        # kernel call.
        C, P, F = _kops.bincount_tiles(dtile, n_nodes)
        counts = P[:, -1] + C[:, -1]                 # per-query fan-in
        # Phase 2 — tile-local sort on segmented keys: equal dests keep
        # local source order; invalid items take the sentinel bucket
        # n_nodes and sort last, below the int32-max padding.
        lsrc = torch.arange(tile, dtype=torch.int32,
                            device=dev).expand(B * n_tiles, tile).contiguous()
        key = (torch.where(dtile >= 0, dtile, n_nodes) * tile
               + lsrc.view(B, n_tiles, tile)).view(B * n_tiles, tile)
        sorted_key, sorted_src = _kops.bitonic_sort(key, lsrc)
        sorted_dest = (sorted_key // tile).long().view(B, n_tiles, tile)
        # Phase 3 — global FIFO rank: in-tile rank (sorted position minus
        # the dest run's first in-tile slot) plus the cross-tile prefix.
        # Sentinel columns close both tables for invalid/padded items.
        first = torch.cat([F, F[..., -1:] + C[..., -1:]], dim=-1)
        cross = torch.cat([P, torch.zeros((B, n_tiles, 1), dtype=P.dtype,
                                          device=dev)], dim=-1)
        pos = torch.arange(tile, dtype=torch.int32, device=dev)
        rank_sorted = (pos - torch.gather(first, -1, sorted_dest)
                       + torch.gather(cross, -1, sorted_dest))
        # Phase 4 — scatter ranks back to source order (tile-local inverse
        # permutation), then drop the tail padding.
        rank = torch.zeros((B, n_tiles, tile), dtype=torch.int32, device=dev)
        rank.scatter_(-1, sorted_src.long().view(B, n_tiles, tile),
                      rank_sorted)
        rank = rank.view(B, -1)[:, :n]

    # Materialize through the tail shared with the dense shuffle; only the
    # remaining stats come from the kernel-computed counts.
    box, max_sent = materialize_mailbox(dests, payload, flat_dest, valid,
                                        rank, n_nodes, capacity)
    stats = RoundStats(
        items_sent=counts.sum(-1).to(torch.int32),
        max_sent=max_sent,
        max_received=(counts.max(-1).values.to(torch.int32) if n_nodes
                      else torch.zeros((B,), dtype=torch.int32, device=dev)),
        dropped=(counts - capacity).clamp_min(0).sum(-1).to(torch.int32),
    )
    return box, stats


def kernel_shuffle(dests: torch.Tensor, payload: Payload, n_nodes: int,
                   capacity: int, *, tile_n: Optional[int] = None
                   ) -> Tuple[Mailbox, RoundStats]:
    """Kernel-composed Shuffle: deliver item j to node ``dests[j]``.

    Contract identical to :func:`repro_torch.core.mrmodel.shuffle`:
    ``dests`` any-shape int32 with entries in [-1, n_nodes), < 0 = "no
    item"; items are delivered FIFO in flattened source order into slots
    0..capacity-1, and items ranked past ``capacity`` are dropped and
    counted.  ``tile_n`` overrides the derived tile width (a testing knob;
    it must keep ``(n_nodes+1)·tile_n`` within int32).  Runs as
    :func:`kernel_shuffle_batch` of one query.
    """
    return unbatch_shuffle(*kernel_shuffle_batch(
        dests[None], tree_map(lambda l: l[None], payload), n_nodes,
        capacity, tile_n=tile_n))

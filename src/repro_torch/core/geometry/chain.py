"""Batched monotone chain — the reducer-local f of the 2-D hull.

The JAX package runs Andrew's monotone chain as a ``lax.scan`` over each
padded run, with a ``lax.while_loop`` of pops at every step, under ``vmap``
over the mailbox's nodes.  An eager PyTorch loop would launch a few tensor
operations per slot, far too many for a run of millions of slots, so here
the chain is one kernel call (:func:`repro_torch.kernels.ops.
monotone_chain`) over the whole mailbox: the hand-written CUDA kernel on
the card, its plain version on the CPU.

Degenerate inputs are handled in-array as in the JAX package: invalid slots
sort to the end, duplicate points are masked out by sorted adjacency, and
runs of 0/1/2 distinct points fall out of the same code path.  Before the
chain, each run's live slots are compacted, in order, to a prefix: the JAX
chain skips a dead slot without touching its stack, so the compacted run
gives the same chain.

Orientation convention (shared with the oracle): pops on cross <= 0, so
collinear points are excluded; output is the strict hull in CCW order
starting at the lexicographic minimum (lower chain left-to-right, then upper
chain right-to-left, endpoints not repeated).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ...kernels import ops

#: Sentinel coordinate for invalid slots: finite (no NaN poisoning in masked
#: lanes) yet larger than any real coordinate, so invalid slots lexsort last.
BIG = 1e30


def sort_dedup_runs(pts: torch.Tensor, valid: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lex-sort each node's run by (x, y) and mask out duplicate points.

    ``pts``: (V, cap, 2) float32; ``valid``: (V, cap).  Returns (sorted pts
    with invalid slots at BIG, ok mask of live distinct slots).  Two stable
    argsorts (y then x) realize the lexicographic order batched over nodes;
    the default argsort is not stable and would break ties out of order."""
    x = torch.where(valid, pts[..., 0], BIG)
    y = torch.where(valid, pts[..., 1], BIG)
    o1 = torch.argsort(y, dim=-1, stable=True)
    o2 = torch.argsort(torch.gather(x, -1, o1), dim=-1, stable=True)
    order = torch.gather(o1, -1, o2)
    spts = torch.gather(pts, -2, order[..., None].expand(pts.shape))
    sval = torch.gather(valid, -1, order)
    spts = torch.where(sval[..., None], spts, BIG)
    dup = torch.cat([
        torch.zeros_like(sval[..., :1]),
        (spts[..., 1:, :] == spts[..., :-1, :]).all(-1)
        & sval[..., 1:] & sval[..., :-1]], dim=-1)
    return spts, sval & ~dup


def _compact(spts: torch.Tensor, ok: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each run's live slots moved, in order, to a prefix, cut to the
    longest run: ((V, L, 2) points, (V,) int32 counts).  Dead slots write
    into a spill column past the run, cut off.  Reading L costs one host
    sync per call; for a batch's runs, one for the whole batch."""
    V, cap, _ = spts.shape
    # Each live slot's rank in its run: one cumsum over all runs, less the
    # live slots of the runs before.  PyTorch's scan along the last axis of
    # a few long runs (a batch's finalize: four runs of 2^24 slots) took
    # 32 ms on an H100 (chip_smoke.py, phase batch-hull2d's profile); one
    # flat scan takes its fast path.
    live = ok.sum(-1)
    before = torch.cumsum(live, 0) - live
    rank = torch.cumsum(ok.reshape(-1), 0).view(V, cap) - before[:, None]
    pos = torch.where(ok, rank - 1, cap)
    packed = spts.new_zeros((V, cap + 1, 2)).scatter_(
        1, pos[..., None].expand(V, cap, 2), spts)
    counts = live.to(torch.int32)
    L = int(counts.max()) if V else 0
    return packed[:, :L].contiguous(), counts


def hull_of_runs(pts: torch.Tensor, valid: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reducer-local hulls of every mailbox node at once.

    ``pts``: (..., V, cap, 2) float32 mailbox payload; ``valid``: (..., V,
    cap), a batch's queries on the leading axis.  Returns (hulls (..., V,
    cap, 2) CCW from each lex-min with zero padding, counts (..., V)
    int32), equal to the JAX package's on every engine backend.  All runs
    of a batch go through one ``monotone_chain`` call, cut to the batch's
    longest run: the chain reads no slot past a run's count and pads its
    hull with zeros, so each query's hulls are those of a call on its own
    runs."""
    *lead, V, cap, _ = pts.shape
    spts, ok = sort_dedup_runs(pts.reshape(-1, cap, 2),
                               valid.reshape(-1, cap))
    packed, counts = _compact(spts, ok)
    hull, h = ops.monotone_chain(packed, counts)
    out = pts.new_zeros((spts.shape[0], cap, 2))
    out[:, :hull.shape[1]] = hull
    return out.view(*lead, V, cap, 2), h.view(*lead, V)

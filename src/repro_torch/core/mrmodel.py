"""Generic MapReduce computation model (paper §2, Theorem 2.1) in PyTorch.

The paper models a MapReduce computation as rounds on a dynamic directed graph
G = (V, E):  each node v holds a state A_v(r) of items; every round, a
sequential function f maps A_v(r) to a set B_v(r) of (destination, item)
pairs; items are routed to their destinations, forming A_v(r+1).  Theorem 2.1:
if every node sends / keeps / receives at most M items per round, the
computation runs in the I/O-memory-bound MapReduce framework with unchanged
round complexity R and communication complexity C.

Node states are *fixed-capacity mailboxes*: nests of tensors with leading
dims (V, M) plus a validity mask.  Routing is a stable sort by destination
plus a rank-addressed scatter; overflow is returned as an explicit drop
counter.  This is the PyTorch counterpart of ``repro.core.mrmodel`` with the
same results bit for bit.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from .._tree import tree_map
from .costmodel import MRCost, RoundStats

Payload = Any  # nest of tensors with leading dims (V, M, ...)

#: shuffle statistics are the per-round stats the engines account
ShuffleStats = RoundStats

#: slots past a mailbox that take the writes of items that do not land
_SPILL = 1024


class Mailbox(NamedTuple):
    """State A_v(r) for all nodes: ``payload`` leaves have shape (V, M, ...),
    or (B, V, M, ...) for a batch of B queries (``valid`` (B, V, M))."""

    payload: Payload
    valid: torch.Tensor  # (V, M) bool

    @property
    def n_nodes(self) -> int:
        return self.valid.shape[-2]

    @property
    def capacity(self) -> int:
        return self.valid.shape[-1]


def make_mailbox(payload: Payload, valid: torch.Tensor) -> Mailbox:
    return Mailbox(payload=payload, valid=valid.to(torch.bool))


def empty_like(box: Mailbox) -> Mailbox:
    return Mailbox(payload=tree_map(torch.zeros_like, box.payload),
                   valid=torch.zeros_like(box.valid))


def materialize_mailbox(dests: torch.Tensor, payload: Payload,
                        flat_dest: torch.Tensor, valid: torch.Tensor,
                        rank: torch.Tensor, n_nodes: int,
                        capacity: int) -> Tuple[Mailbox, torch.Tensor]:
    """Shared placement tail of both shuffle implementations (dense and
    :func:`repro_torch.core.kshuffle.kernel_shuffle`), batch first: B
    queries' items, ``dests`` (B, ...) and payload leaves (B, ...) with
    ``flat_dest``, ``valid`` and ``rank`` (B, n).  Keeps items whose
    arrival ``rank`` fits ``capacity``, scatters payload + validity into the
    (B, V, capacity) mailbox, and computes each query's per-source-node
    ``max_sent`` (B,).

    PyTorch has no ``mode="drop"`` scatter, and on CUDA an out-of-range
    index is a device-side assert, so every item that does not land writes
    into a spill area past the mailboxes, which is then cut off.  That keeps
    the scatter free of a host read of how many items land; the spill slot
    is the item's rank modulo ``_SPILL`` (ranks of items that do not land
    are distinct per destination), so millions of such writes do not all
    contend for one address."""
    B, n = flat_dest.shape
    slots = n_nodes * capacity
    in_range = valid & (rank < capacity)
    base = torch.arange(B, device=flat_dest.device)[:, None] * slots
    slot = torch.where(in_range,
                       base + flat_dest.long() * capacity + rank.long(),
                       B * slots + (rank.long() & (_SPILL - 1))).reshape(-1)

    def place(leaf: torch.Tensor) -> torch.Tensor:
        flat = leaf.reshape((B * n,) + tuple(leaf.shape[dests.ndim:]))
        out = torch.zeros((B * slots + _SPILL,) + tuple(flat.shape[1:]),
                          dtype=flat.dtype, device=flat.device)
        out[slot] = flat
        return out[:B * slots].view((B, n_nodes, capacity)
                                    + tuple(flat.shape[1:]))

    new_payload = tree_map(place, payload)
    new_valid = place(in_range)
    if dests.ndim >= 3 and n:
        sent_per_node = valid.reshape(B, dests.shape[1], -1).sum(-1)
        max_sent = sent_per_node.max(-1).values.to(torch.int32)
    else:
        # Empty (V, M) sends have no source nodes: max_sent = 0, matching
        # the reference backend's max(initial=0).
        max_sent = torch.full((B,), 0 if dests.ndim >= 3 else 1,
                              dtype=torch.int32, device=valid.device)
    return Mailbox(payload=new_payload, valid=new_valid), max_sent


def fifo_rank(flat_dest: torch.Tensor, n_nodes: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FIFO rank of each item among the items with its destination, in
    flattened source order, and the sort key (``n_nodes`` for items with
    dest < 0, which rank among themselves).  Both int32, of
    ``flat_dest``'s shape (..., n): each row of leading indices ranks on
    its own.  The dense Shuffle's ranking, shared with the FIFO queues'
    enqueue."""
    shape = flat_dest.shape
    n = shape[-1]
    dev = flat_dest.device
    sort_key = torch.where(flat_dest >= 0, flat_dest, n_nodes).to(torch.int32)
    if n == 0:
        return torch.zeros(shape, dtype=torch.int32, device=dev), sort_key
    rows = sort_key.reshape(-1, n)
    # One stable sort by (row, destination); invalid items sort to the end
    # of their row.
    seg = (torch.arange(rows.shape[0], device=dev)[:, None] * (n_nodes + 1)
           + rows).reshape(-1)
    order = torch.argsort(seg, stable=True)
    sorted_seg = seg[order]
    # Rank of each item within its (row, destination) segment.
    first_occurrence = torch.searchsorted(sorted_seg, sorted_seg, side="left")
    rank_sorted = (torch.arange(seg.shape[0], device=dev)
                   - first_occurrence).to(torch.int32)
    # Scatter back to source order.
    rank = torch.zeros((seg.shape[0],), dtype=torch.int32, device=dev)
    rank[order] = rank_sorted
    return rank.view(shape), sort_key


def scatter_or_drop(base: torch.Tensor, index: torch.Tensor,
                    ok: torch.Tensor, values: torch.Tensor,
                    salt: torch.Tensor) -> torch.Tensor:
    """A copy of ``base`` with ``base[index[i]] = values[i]`` wherever
    ``ok[i]``: the drop-mode scatter PyTorch lacks.  The other writes land
    in a spill area past the end, at ``salt`` modulo ``_SPILL`` (distinct
    salts keep them from contending for one address), which is cut off."""
    n = base.shape[0]
    out = torch.cat([base, base.new_empty((_SPILL,) + tuple(base.shape[1:]))])
    out[torch.where(ok, index.long(), n + (salt.long() & (_SPILL - 1)))] = \
        values.to(base.dtype)
    return out[:n]


def shuffle_batch(dests: torch.Tensor, payload: Payload, n_nodes: int,
                  capacity: int) -> Tuple[Mailbox, ShuffleStats]:
    """The Shuffle step of B queries at once: ``dests`` (B, ...) and payload
    leaves (B, ...) in, a (B, V, capacity) mailbox and (B,) stats out, each
    row what :func:`shuffle` gives for that query alone."""
    B = dests.shape[0]
    flat_dest = dests.reshape(B, -1)
    valid = flat_dest >= 0
    rank, sort_key = fifo_rank(flat_dest, n_nodes)
    box, max_sent = materialize_mailbox(dests, payload, flat_dest, valid,
                                        rank, n_nodes, capacity)
    # invalid items count into a sentinel bin n_nodes, cut off
    row = torch.arange(B, device=flat_dest.device)[:, None] * (n_nodes + 1)
    recv_counts = torch.bincount(
        (sort_key.long() + row).reshape(-1),
        minlength=B * (n_nodes + 1)).view(B, n_nodes + 1)[:, :n_nodes]
    stats = ShuffleStats(
        items_sent=valid.sum(-1).to(torch.int32),
        max_sent=max_sent,
        max_received=(recv_counts.max(-1).values.to(torch.int32) if n_nodes
                      else torch.zeros((B,), dtype=torch.int32,
                                       device=flat_dest.device)),
        dropped=(valid & (rank >= capacity)).sum(-1).to(torch.int32),
    )
    return box, stats


def unbatch_shuffle(box: Mailbox, stats: ShuffleStats
                    ) -> Tuple[Mailbox, ShuffleStats]:
    """Row 0 of a batched shuffle's result: a single query's mailbox and
    0-d stats."""
    return (Mailbox(payload=tree_map(lambda l: l[0], box.payload),
                    valid=box.valid[0]),
            ShuffleStats(*(s[0] for s in stats)))


def shuffle(dests: torch.Tensor, payload: Payload, n_nodes: int,
            capacity: int) -> Tuple[Mailbox, ShuffleStats]:
    """The Shuffle step: deliver item j to node ``dests[j]``.

    ``dests`` is any-shape int32; entries < 0 mark invalid (non-existent)
    items.  ``payload`` leaves share ``dests``'s leading shape.  Items are
    delivered in stable (source-order) FIFO order into per-node slots
    ``0..capacity-1``; items ranked past ``capacity`` at their destination are
    dropped and counted.

    This is the dense implementation (stable argsort + rank-addressed
    scatter) and the semantics oracle of
    :func:`repro_torch.core.kshuffle.kernel_shuffle`; it runs as
    :func:`shuffle_batch` of one query.
    """
    return unbatch_shuffle(*shuffle_batch(
        dests[None], tree_map(lambda l: l[None], payload), n_nodes,
        capacity))


# A round function f: (round_idx, node_ids, mailbox) -> (dests, payload).
# ``dests`` has shape (V, M_out); -1 entries are "no item".  Keeping item x at
# node v is expressed by dests[v, j] = v — exactly the paper's "keep" primitive.
RoundFn = Callable[[int, torch.Tensor, Mailbox], Tuple[torch.Tensor, Payload]]


def run_round(f: RoundFn, box: Mailbox, round_idx: int,
              cost: Optional[MRCost] = None,
              capacity: Optional[int] = None,
              engine=None) -> Tuple[Mailbox, ShuffleStats]:
    """Execute one round of the generic computation: apply f, then shuffle.

    Wrapper over ``engine.run_round`` (default: the shared LocalEngine on
    the card) that also reports into the mutable ``cost`` adapter."""
    if engine is None:
        engine = _default_engine()
    new_box, stats = engine.run_round(f, box, round_idx, capacity=capacity)
    if cost is not None:
        cost.round(items_sent=int(stats.items_sent),
                   max_io=int(torch.maximum(stats.max_sent,
                                            stats.max_received)))
    return new_box, stats


def run_rounds(f: RoundFn, box: Mailbox, n_rounds: int,
               cost: Optional[MRCost] = None,
               capacity: Optional[int] = None,
               engine=None) -> Mailbox:
    """Drive R rounds through an engine and raise on capacity overflow."""
    if engine is None:
        engine = _default_engine()
    box, accum = engine.run_rounds(f, box, n_rounds, capacity=capacity)
    engine.require_no_drops(accum, what=f"{n_rounds} rounds at capacity "
                            f"M={capacity or box.capacity}")
    if cost is not None:
        cost.absorb(accum)
    return box


def _default_engine():
    from .engine import default_engine    # deferred: engine imports mrmodel
    return default_engine()

"""FIFO queues in the MapReduce model (paper §4.2, Theorem 4.2).

The modified framework lets a node receive and hold unboundedly many items
(arriving from <= M distinct senders per round) while still sending <= M;
excess items wait in a FIFO input buffer and are fed to f in O(M) chunks.
Theorem 4.2: any R-round, C-communication algorithm in the modified
framework runs in the strict I/O-memory-bound model in O(R) rounds and O(C)
communication, by materializing each node's buffer as a doubly-linked list
of [M/4, M/2]-full helper nodes (three strict rounds per modified round:
counts -> linking -> delivery).

The queue state is a ring buffer per node (capacity = a multiple of M; each
M-sized slice plays one linked-list helper node).  Every modified round runs
the paper's R1/R2/R3, counted as 3 strict rounds:
  R1  senders announce counts n_{u,v};
  R2  receivers assign arrivals to helper slots (ring-buffer offsets);
  R3  items are delivered to their slots.
Dequeue feeds the head-most <= M items of each queue to f.

An item with dest < 0 is no item: it writes nothing.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from .._device import as_device
from .._tree import tree_leaves, tree_map
from .costmodel import CostAccum, MRCost
from .mrmodel import fifo_rank, scatter_or_drop


class QueueState(NamedTuple):
    """Per-node FIFO ring buffers: ``buf`` leaves are (V, cap, ...)."""
    buf: Any                    # payload nest
    head: torch.Tensor          # (V,) int32 — index of oldest item
    size: torch.Tensor          # (V,) int32 — items in queue

    @property
    def capacity(self) -> int:
        return self.head_buf().shape[1]

    def head_buf(self) -> torch.Tensor:
        return tree_leaves(self.buf)[0]


def make_queues(n_nodes: int, capacity: int, payload_template: Any,
                device="cuda") -> QueueState:
    """Empty queues of ``capacity`` items at each of ``n_nodes`` nodes, one
    ring buffer per leaf of ``payload_template`` (its shape and dtype per
    item), on the card unless ``device`` says otherwise."""
    dev = as_device(device, "queues")

    def ring(t):
        t = torch.as_tensor(t)
        return torch.zeros((n_nodes, capacity) + tuple(t.shape),
                           dtype=t.dtype, device=dev)

    return QueueState(buf=tree_map(ring, payload_template),
                      head=torch.zeros((n_nodes,), dtype=torch.int32,
                                       device=dev),
                      size=torch.zeros((n_nodes,), dtype=torch.int32,
                                       device=dev))


def enqueue(q: QueueState, dests: torch.Tensor, payload: Any,
            cost: Optional[MRCost] = None) -> Tuple[QueueState, torch.Tensor]:
    """R1-R3 of Theorem 4.2: append items to their destinations' FIFO queues.

    ``dests``: int, any shape; < 0 = no item, which writes nothing.
    ``payload`` leaves lead with ``dests``' shape.  Returns (new_state,
    n_overflow): overflow only if a ring buffer is exhausted (a violation of
    the capacity model, not a protocol failure); overflowing items write
    nothing either."""
    cap = q.capacity
    n_nodes = q.head.shape[0]
    dev = q.head.device
    dests = torch.as_tensor(dests, device=dev)
    flat_dest = dests.reshape(-1).to(torch.int32)
    n = flat_dest.shape[0]
    valid = flat_dest >= 0
    rank, _ = fifo_rank(flat_dest, n_nodes)
    node = flat_dest.clamp(0, n_nodes - 1).long()
    write_pos = (q.head[node] + q.size[node] + rank) % cap
    room = rank < (cap - q.size[node])
    ok = valid & room
    overflow = (valid & ~room).sum()
    slot = node * cap + write_pos.long()          # ring slot dest * cap + pos

    def place(buf_leaf, pay_leaf):
        item = tuple(buf_leaf.shape[2:])
        flat = torch.as_tensor(pay_leaf, device=dev).reshape((n,) + item)
        return scatter_or_drop(buf_leaf.reshape((-1,) + item), slot, ok,
                               flat, rank).view(buf_leaf.shape)

    new_buf = tree_map(place, q.buf, payload)
    recv = torch.bincount(torch.where(ok, flat_dest, n_nodes).long(),
                          minlength=n_nodes + 1)[:n_nodes].to(torch.int32)
    new_size = q.size + recv
    if cost is not None:
        n_sent = valid.sum()
        # Theorem 4.2: three strict rounds (counts, linking, delivery); the
        # count/link rounds move O(#senders) control items, delivery moves
        # the payload.  Per-helper-node I/O stays <= M by construction.
        ctl = n_sent.clamp_max(n_nodes * 2)
        accum = (CostAccum.zero(dev)
                 .add_round(items_sent=ctl, max_io=n_sent.clamp_max(cap))
                 .add_round(items_sent=ctl, max_io=n_sent.clamp_max(cap))
                 .add_round(items_sent=n_sent, max_io=recv.max()))
        cost.absorb(accum)                    # one host sync per enqueue
    return QueueState(buf=new_buf, head=q.head, size=new_size), overflow


def dequeue(q: QueueState, M: int) -> Tuple[QueueState, Any, torch.Tensor]:
    """Feed the head-most min(size, M) items per node to the consumer.

    Returns (new_state, payload (V, M, ...), valid (V, M)) in FIFO order."""
    cap = q.capacity
    take = q.size.clamp_max(M)
    offs = torch.arange(M, dtype=torch.int32, device=q.head.device)
    pos = ((q.head[:, None] + offs[None, :]) % cap).long()
    valid = offs[None, :] < take[:, None]

    def gather(buf_leaf):
        item = tuple(buf_leaf.shape[2:])
        idx = pos.reshape(pos.shape + (1,) * len(item)).expand(
            pos.shape + item)
        return torch.gather(buf_leaf, 1, idx)

    out = tree_map(gather, q.buf)
    new_head = (q.head + take) % cap
    new_size = q.size - take
    return QueueState(buf=q.buf, head=new_head, size=new_size), out, valid


def run_queued(f: Callable, q: QueueState, M: int, n_rounds: int,
               cost: Optional[MRCost] = None,
               stop_when_empty: bool = True) -> QueueState:
    """Drive a modified-framework algorithm: each modified round dequeues
    <= M items per node, applies f, and enqueues f's outputs.

    ``f(round, node_ids, items, valid) -> (dests, payload)`` — the strict
    model's RoundFn contract, fed from the FIFO buffers.  Reads the overflow
    count and the queued total back to the host once each a round."""
    n_nodes = q.head.shape[0]
    node_ids = torch.arange(n_nodes, dtype=torch.int32, device=q.head.device)
    for r in range(n_rounds):
        q, items, valid = dequeue(q, M)
        dests, payload = f(r, node_ids, items, valid)
        q, overflow = enqueue(q, dests, payload, cost=cost)
        if int(overflow):
            raise RuntimeError(f"modified round {r}: ring buffer exhausted")
        if stop_when_empty and int(q.size.sum()) == 0:
            break
    return q

"""The paper's primitives as collectives over a ``torch.distributed`` group.

The port of the JAX package's ``repro.core.distributed``.  Each function is
the collective counterpart of a :mod:`repro_torch.core` algorithm:

  shuffle_alltoall      -- the Shuffle step over a process group (Thm 2.1);
                           the routing layer of the sharded engine's hop.
  keyed_hop             -- phase 1 of the sharded Shuffle: a lossless
                           ``shuffle_alltoall`` to the shard owning each
                           destination node.
  funnel_allreduce      -- a two-level invisible funnel with f = + :
                           reduce-scatter over the inner group, sum over
                           the outer group, then all-gather.
  softmax_merge_axis    -- the funnel under the (max, sum-exp) semigroup:
                           merges attention partials across a group.
  sharded_sample_sort   -- §4.3 sample sort as one local sort + sample
                           all-gather + bucket all-to-all + local merge.
  segment_scatter_add   -- funnel-write with f = + for many-to-one writes
                           (local; no collective).
  copy_to_region, reduce_from_region, gather_from_region
                        -- Megatron's tensor-parallel pair (and the gather
                           that leaves a region through a concatenation).
  enter_sequence, leave_sequence
                        -- the pair under Megatron sequence parallelism:
                           an all-gather of the sequence into a region (a
                           reduce-scatter back), a reduce-scatter of the
                           sequence out of it (an all-gather back).
  fsdp_gather           -- FSDP-3's parameter gather, whose backward is the
                           funnel's reduce-scatter over the data axis.

Where the JAX functions run inside ``shard_map`` over an ``axis_name``,
these run on every rank of a process group (``group=None`` is the default
group) on that rank's tensors: ``lax.all_to_all(tiled=True)`` becomes
``all_to_all_single`` on fixed-size ``(n_shards, capacity, ...)`` buffers,
``psum`` / ``pmax`` ``all_reduce`` with SUM / MAX, ``psum_scatter``
``reduce_scatter_tensor``, ``all_gather`` ``all_gather_into_tensor`` and
``axis_index`` the rank within the group.  Boolean tensors cross the wire
as ``uint8``.  The caller starts the process group.  At world size 1 every
function degenerates to the local operation.

This module is the package's one door to ``torch.distributed``'s
collectives (:func:`all_reduce_`, :func:`all_gather_into`,
:func:`reduce_scatter_into`, :func:`all_to_all_into`, :func:`permute`):
each runs inside every active counter's ``collective(op, nbytes)``
context, a ``TorchDispatchMode`` on the dispatch stack with that method
(:class:`repro_torch.launch.dryrun.Counter`), as
:func:`repro_torch.kernels.ops.counted` reports kernel calls.  ``op`` is
one of XLA's names (:data:`COLLECTIVE_OPS`) and ``nbytes`` the bytes of
the result on this rank, the JAX dry run's convention; the counter keeps
the aten ops a backend runs inside the call (gloo copies a result on
``wait``) out of its counts.  A collective over a group of one rank moves
nothing and reports ``nbytes`` None, so the count is the same on any
backend (gloo, NCCL, or the stand-in group of
:func:`repro_torch.launch.mesh.stand_in_mesh`, on which the door counts
and makes no call).
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple, Sequence, Tuple

import torch
import torch.distributed as dist

from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from .._tree import tree_map
from .mrmodel import _SPILL

#: the collectives by the names XLA's HLO gives them
COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")

# the names newer releases give reduce_scatter_tensor and
# all_gather_into_tensor (same signatures)
_reduce_scatter = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)
_all_gather = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)


def _wire(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.dtype == torch.bool else t


# ---------------------------------------------------------------------------
# The door: every collective of the package, counted
# ---------------------------------------------------------------------------

def _moves(group) -> bool:
    """Whether a collective over ``group`` moves data: not on the
    stand-in process group (:func:`repro_torch.launch.mesh.stand_in_mesh`),
    whose collectives return at once; the door counts them all the same
    and skips the call (the dry run's ranks make tens of thousands)."""
    return dist.get_backend(group) != "fake"


def _counted(op: str, result: torch.Tensor, group):
    """The context of one collective ``op`` whose result is ``result``:
    each active counter's ``collective(op, nbytes)``, ``nbytes`` None
    over a group of one rank."""
    stack = contextlib.ExitStack()
    nbytes = (None if dist.get_world_size(group) == 1
              else result.numel() * result.element_size())
    for mode in _get_current_dispatch_mode_stack():
        hook = getattr(mode, "collective", None)
        if hook is not None:
            stack.enter_context(hook(op, nbytes))
    return stack


def all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM,
                group=None) -> torch.Tensor:
    """``t`` reduced over ``group`` in place (``t`` contiguous)."""
    with _counted("all-reduce", t, group):
        if _moves(group):
            dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_into(out: torch.Tensor, x: torch.Tensor,
                    group=None) -> torch.Tensor:
    """Every rank's ``x`` into ``out`` along the leading axis, in rank
    order."""
    with _counted("all-gather", out, group):
        if _moves(group):
            _all_gather(_wire(out), _wire(x), group=group)
    return out


def reduce_scatter_into(out: torch.Tensor, x: torch.Tensor,
                        group=None) -> torch.Tensor:
    """The group's SUM of ``x``, rank i's block of the leading axis into
    ``out``."""
    with _counted("reduce-scatter", out, group):
        if _moves(group):
            _reduce_scatter(out, x, group=group)
    return out


def all_to_all_into(recv: torch.Tensor, send: torch.Tensor,
                    group=None) -> torch.Tensor:
    """Block j of ``send`` to rank j; block i of ``recv`` from rank i."""
    with _counted("all-to-all", recv, group):
        if _moves(group):
            dist.all_to_all_single(_wire(recv), _wire(send), group=group)
    return recv


def permute(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """``x`` sent to group rank r + ``shift`` (mod the group's size); the
    result is what rank r - ``shift`` sent (``lax.ppermute``)."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    with _counted("collective-permute", out, group):
        if not _moves(group):
            return out
        ops = [dist.P2POp(dist.isend, x,
                          dist.get_global_rank(group, (r + shift) % n),
                          group),
               dist.P2POp(dist.irecv, out,
                          dist.get_global_rank(group, (r - shift) % n),
                          group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def _all_to_all(send: torch.Tensor, group) -> torch.Tensor:
    send = send.contiguous()
    return all_to_all_into(torch.empty_like(send), send, group)


def _all_gather_plain(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],)
                      + tuple(x.shape[1:]))
    return all_gather_into(out, x, group)


def _all_reduce_plain(x: torch.Tensor, op, group) -> torch.Tensor:
    # NCCL takes contiguous tensors only (a gradient may arrive strided)
    out = x.clone(memory_format=torch.contiguous_format)
    return all_reduce_(out, op, group)


class _AllToAll(torch.autograd.Function):
    """A tiled all-to-all is a permutation of blocks across the group; its
    backward sends each block of the gradient back where it came from,
    which is the same all-to-all."""

    @staticmethod
    def forward(ctx, send, group):
        ctx.group = group
        return _all_to_all(send, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


class _AllGather(torch.autograd.Function):
    """The backward of an all-gather is a reduce-scatter: every rank's
    block of the gradient, summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather_plain(x, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.group), None


class _AllReduceSum(torch.autograd.Function):
    """The backward of a SUM all-reduce is a SUM all-reduce: every rank's
    output reads every rank's input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_plain(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_plain(grad, dist.ReduceOp.SUM, ctx.group), None


def _tracked(x: torch.Tensor) -> bool:
    return x.requires_grad and torch.is_grad_enabled()


# The collectives below carry a gradient where their input does (a float
# tensor that requires grad, under grad mode): the objective is the sum of
# every rank's loss, and each rank calls ``backward`` on its own, so the
# backward collectives meet as the forward ones did.  Other inputs (ints,
# bools, detached floats) take the plain collective.

def all_to_all(send: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.all_to_all(split_axis=0, concat_axis=0, tiled=True)``: block
    j of ``send``'s leading axis goes to rank j; block i of the result
    came from rank i."""
    if _tracked(send):
        return _AllToAll.apply(send, group)
    return _all_to_all(send, group)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the leading axis in rank
    order (``lax.all_gather(tiled=True)``)."""
    if _tracked(x):
        return _AllGather.apply(x, group)
    return _all_gather_plain(x, group)


def all_reduce(x: torch.Tensor, op=dist.ReduceOp.SUM,
               group=None) -> torch.Tensor:
    """``psum`` (SUM) or ``pmax`` (MAX) as a new tensor.  A SUM carries a
    gradient; a MAX carries none (its result is detached)."""
    if _tracked(x):
        if op == dist.ReduceOp.SUM:
            return _AllReduceSum.apply(x, group)
        x = x.detach()
    return _all_reduce_plain(x, op, group)


def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.psum_scatter(tiled=True)``: the group's SUM of ``x``, whose
    leading axis is split into one block a rank; rank i keeps block i.
    Carries no gradient."""
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // dist.get_world_size(group),)
                      + tuple(x.shape[1:]))
    return reduce_scatter_into(out, x, group)


# ---------------------------------------------------------------------------
# Tensor and parameter parallelism: the Megatron pair and the FSDP gather
# ---------------------------------------------------------------------------
# A value inside a tensor-parallel region is the rank's own (its heads, its
# d_ff columns, its experts); every rank's gradient of it is its part of
# the objective's.  A value outside is replicated over the group, with the
# whole gradient on every rank.  ``copy_to_region`` enters a region,
# ``reduce_from_region`` leaves it through a sum, ``gather_from_region``
# through a concatenation.

class _CopyToRegion(torch.autograd.Function):
    """Identity forward; the backward sums the ranks' parts (all-reduce)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_plain(grad, dist.ReduceOp.SUM, ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    """All-reduce forward; the backward hands the replicated gradient to
    every rank's part unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_plain(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromRegion(torch.autograd.Function):
    """All-gather of the ranks' blocks along ``dim``; the backward keeps
    the rank's block of the replicated gradient."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        out = _all_gather_plain(x.movedim(dim, 0), group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        n = grad.shape[ctx.dim] // dist.get_world_size(ctx.group)
        r = dist.get_rank(ctx.group)
        return grad.narrow(ctx.dim, r * n, n).contiguous(), None, None


def _seq_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' slices of the sequence (dim 1) of ``x`` (b, s / n, ...)
    joined in rank order into a contiguous (b, s, ...)."""
    n = dist.get_world_size(group)
    y = _all_gather_plain(x, group)
    return y.unflatten(0, (n, -1)).transpose(0, 1).flatten(1, 2)


def _seq_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """The group's SUM of ``x`` (b, s, ...), the rank's slice of the
    sequence kept: (b, s / n, ...)."""
    n = dist.get_world_size(group)
    # contiguous before the collective: NCCL refuses strided tensors
    y = x.unflatten(1, (n, -1)).transpose(0, 1).flatten(0, 1)
    return reduce_scatter(y, group)


class _EnterSequence(torch.autograd.Function):
    """Megatron sequence parallelism's entry into a region: the ranks'
    slices of the sequence (dim 1) gathered in rank order; the backward
    sums the ranks' parts of the gradient and keeps the rank's slice
    (reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _seq_scatter(grad, ctx.group), None


class _LeaveSequence(torch.autograd.Function):
    """Megatron sequence parallelism's exit from a region: the ranks'
    parts summed, the rank's slice of the sequence (dim 1) kept
    (reduce-scatter); the backward gathers the slices' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_scatter(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _seq_gather(grad, ctx.group), None


def enter_sequence(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (b, s / n, ...), the rank's slice of the sequence, gathered
    to (b, s, ...) as the region's input: each rank's gradient of it is
    its part of the objective's."""
    if _tracked(x):
        return _EnterSequence.apply(x, group)
    return _seq_gather(x, group)


def leave_sequence(x: torch.Tensor, group) -> torch.Tensor:
    """The region's output (b, s, ...), the ranks' parts, summed and cut
    to the rank's slice of the sequence (b, s / n, ...)."""
    if _tracked(x):
        return _LeaveSequence.apply(x, group)
    return _seq_scatter(x, group)


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the backward scales the gradient."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def copy_to_region(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: ``x`` (replicated) as the rank's own value."""
    return _CopyToRegion.apply(x, group) if _tracked(x) else x


def reduce_from_region(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: the group's SUM of the ranks' parts, replicated."""
    if _tracked(x):
        return _ReduceFromRegion.apply(x, group)
    return _all_reduce_plain(x, dist.ReduceOp.SUM, group)


def gather_from_region(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' blocks along ``dim`` concatenated in rank order,
    replicated."""
    if _tracked(x):
        return _GatherFromRegion.apply(x, dim % x.ndim, group)
    return _all_gather_plain(x.movedim(dim, 0), group).movedim(0, dim)


def scale_grad(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x``, whose gradient is multiplied by ``scale``."""
    return _ScaleGrad.apply(x, scale) if _tracked(x) else x


def gather_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """:func:`all_gather` along ``dim`` (its backward a reduce-scatter:
    each rank's gradient of the whole, summed, the rank's block kept)."""
    return all_gather(x.movedim(dim, 0), group).movedim(0, dim)


class _FsdpGather(torch.autograd.Function):
    """A parameter shard made whole along ``dim``, split over ``groups``
    (outermost first, row-major); the backward reduce-scatters the whole
    gradient over ``groups[data]`` into the rank's *region* (its block
    along the data axis, whole along the others) and hands it to
    ``sink(region)``.  The parameter itself gets no gradient."""

    @staticmethod
    def forward(ctx, x, dim, groups, data, sink):
        ctx.dim, ctx.groups, ctx.data, ctx.sink = dim, groups, data, sink
        y = x.movedim(dim, 0)
        for g in reversed(groups):
            y = _all_gather_plain(y, g)
        return y.movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        g = grad.movedim(ctx.dim, 0)
        if ctx.data is not None:
            sizes = [dist.get_world_size(x) for x in ctx.groups]
            pre = 1
            for s in sizes[:ctx.data]:
                pre *= s
            d = sizes[ctx.data]
            y = g.unflatten(0, (pre, d, g.shape[0] // (pre * d)))
            y = y.movedim(1, 0).flatten(0, 2)
            g = reduce_scatter(y, ctx.groups[ctx.data])
        ctx.sink(g.movedim(0, ctx.dim))
        return None, None, None, None, None


def fsdp_gather(x: torch.Tensor, dim: int, groups, data, sink
                ) -> torch.Tensor:
    """FSDP-3's forward gather of a parameter shard (see
    :class:`_FsdpGather`): ``groups`` split ``dim`` row-major, the axis at
    index ``data`` (or None) is the one its backward reduce-scatters over;
    the other axes' sums are left to the caller (the pod hop)."""
    return _FsdpGather.apply(x, dim, tuple(groups), data, sink)


# ---------------------------------------------------------------------------
# Shuffle (Theorem 2.1) — keyed all-to-all routing
# ---------------------------------------------------------------------------

class ShuffleOut(NamedTuple):
    payload: Any               # (n_shards, capacity, ...) per receiving shard
    valid: torch.Tensor        # (n_shards, capacity)
    dropped: torch.Tensor      # 0-d int32: items beyond per-pair capacity


def _fifo_ranks(dests: torch.Tensor, n_groups: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each item's FIFO rank among the items bound for its group, and
    whether its group is in [0, n_groups).  One running count a group:
    n_groups passes over the items, where the items a rank sends shrink
    as the group grows."""
    valid = (dests >= 0) & (dests < n_groups)
    rank = torch.zeros(dests.shape, dtype=torch.int32, device=dests.device)
    for g in range(n_groups):
        mine = dests == g
        rank = torch.where(mine, mine.cumsum(-1, dtype=torch.int32) - 1, rank)
    return rank, valid


def shuffle_alltoall(dests: torch.Tensor, payload: Any, group,
                     capacity: int) -> ShuffleOut:
    """Route each local item to the rank named by ``dests`` (< 0 = none).

    ``capacity`` bounds the items a (sender, receiver) pair carries, the M
    of the I/O-bound model: the send buffer is (n_shards, capacity), slots
    filled in flattened source order, and items ranked past ``capacity``
    are dropped and counted (``dropped`` summed over the group).  Row i of
    the result holds what rank i sent here."""
    n_shards = dist.get_world_size(group)
    flat_dests = dests.reshape(-1)
    n = flat_dests.shape[0]
    rank, valid = _fifo_ranks(flat_dests, n_shards)
    ok = valid & (rank < capacity)
    dropped = (valid & ~ok).sum().to(torch.int32)
    # One send slot an item, shared by every leaf; an item that does not
    # fit writes into a spill area past the buffer (at its rank modulo
    # _SPILL, so that they do not all contend for one address), cut off.
    n_slots = n_shards * capacity
    index = torch.where(ok, flat_dests.long() * capacity + rank,
                        n_slots + (rank & (_SPILL - 1)))

    def pack(leaf):
        flat = leaf.reshape((n,) + tuple(leaf.shape[dests.ndim:]))
        buf = flat.new_zeros((n_slots + _SPILL,) + tuple(flat.shape[1:]))
        buf[index] = flat
        return buf[:n_slots].view((n_shards, capacity)
                                  + tuple(flat.shape[1:]))

    send = tree_map(pack, payload)
    mask = pack(ok)
    recv = tree_map(lambda leaf: all_to_all(leaf, group), send)
    return ShuffleOut(payload=recv, valid=all_to_all(mask, group),
                      dropped=all_reduce(dropped, group=group))


def keyed_hop(dests: torch.Tensor, leaves: Sequence[torch.Tensor], group,
              n_nodes: int) -> Tuple[torch.Tensor, list]:
    """Phase 1 of the sharded Shuffle: the keyed all-to-all hop.

    Routes every local (dest, *leaves) item to the rank that owns node
    ``dest`` (contiguous ownership: rank s owns [s V/k, (s+1) V/k)) with
    per-pair capacity equal to the local item count, so the hop itself is
    lossless: overflow can only happen at the phase-2 scatter, the event
    the local engines count.

    Returns ``(local_dest, recv_flat)``: the rank-local destination of
    each arrival (-1 = empty slot) and the flattened received leaves, in
    source-rank-major order, which with contiguous sources keeps the
    global flattened-source FIFO order the scatter relies on."""
    n_shards = dist.get_world_size(group)
    local_v = n_nodes // n_shards
    flat_dest = dests.reshape(-1).to(torch.int32)
    n_local = flat_dest.shape[0]
    flat_leaves = [l.reshape((n_local,) + tuple(l.shape[dests.ndim:]))
                   for l in leaves]
    owner = torch.where(flat_dest >= 0,
                        flat_dest.clamp(0, n_nodes - 1) // local_v, -1)
    routed = shuffle_alltoall(owner, (flat_dest, flat_leaves), group,
                              capacity=n_local)
    recv_dest, recv_leaves = routed.payload
    recv_valid = routed.valid.reshape(-1)
    shard = dist.get_rank(group)
    local_dest = torch.where(recv_valid,
                             recv_dest.reshape(-1) - shard * local_v, -1)
    recv_flat = [rl.reshape((-1,) + tuple(rl.shape[2:])) for rl in recv_leaves]
    return local_dest, recv_flat


# ---------------------------------------------------------------------------
# Invisible funnel with f = + (Theorem 3.2) — hierarchical reduction
# ---------------------------------------------------------------------------

def funnel_allreduce(x: torch.Tensor, inner_group,
                     outer_group=None, scatter_dim: int = 0) -> torch.Tensor:
    """Two-level funnel all-reduce: reduce-scatter over the (fast, wide)
    inner group, sum over the (slow, narrow) outer group on 1/|inner| of
    the data, then all-gather.  Against a flat sum over both groups this
    moves |inner| times less data over the outer links.  A dimension that
    the inner group does not divide takes the flat sums."""
    k = dist.get_world_size(inner_group)
    if x.shape[scatter_dim] % k != 0:
        y = all_reduce(x, group=inner_group)
        if outer_group is not None:
            all_reduce_(y, group=outer_group)
        return y
    shard = reduce_scatter(x.movedim(scatter_dim, 0), inner_group)
    if outer_group is not None:
        all_reduce_(shard, group=outer_group)
    return all_gather(shard, inner_group).movedim(0, scatter_dim)


def segment_scatter_add(dests: torch.Tensor, values: torch.Tensor,
                        n_cells: int) -> torch.Tensor:
    """Local funnel-write with f = + : combine many-to-one writes into
    cells.  Items with a destination outside [0, n_cells) add nothing."""
    ok = (dests >= 0) & (dests < n_cells)
    idx = torch.where(ok, dests, n_cells).reshape(-1).long()
    flat_val = values.reshape((idx.shape[0],) + tuple(values.shape[dests.ndim:]))
    keep = ok.reshape((-1,) + (1,) * (flat_val.ndim - 1))
    out = values.new_zeros((n_cells + 1,) + tuple(flat_val.shape[1:]))
    out.index_add_(0, idx, torch.where(keep, flat_val, 0))
    return out[:n_cells]


# ---------------------------------------------------------------------------
# (max, sum-exp) semigroup merge — sequence-sharded attention combine
# ---------------------------------------------------------------------------

class AttnPartial(NamedTuple):
    m: torch.Tensor            # running max of logits        (..., )
    l: torch.Tensor            # running sum of exp(logit-m)  (..., )
    o: torch.Tensor            # unnormalized output          (..., d)


def softmax_merge_pair(a: AttnPartial, b: AttnPartial) -> AttnPartial:
    """The commutative semigroup op underlying flash attention/decoding."""
    m = torch.maximum(a.m, b.m)
    ea = torch.exp(a.m - m)
    eb = torch.exp(b.m - m)
    return AttnPartial(m=m, l=a.l * ea + b.l * eb,
                       o=a.o * ea[..., None] + b.o * eb[..., None])


def softmax_merge_axis(p: AttnPartial, group) -> torch.Tensor:
    """Funnel-combine attention partials across a group and normalize: a
    MAX all-reduce for m, SUM all-reduces for the rescaled (l, o)."""
    m_g = all_reduce(p.m, dist.ReduceOp.MAX, group)
    scale = torch.exp(p.m - m_g)
    l_g = all_reduce(p.l * scale, group=group)
    o_g = all_reduce(p.o * scale[..., None], group=group)
    return o_g / l_g.clamp_min(1e-30)[..., None]


# ---------------------------------------------------------------------------
# §4.3 sample sort, sharded
# ---------------------------------------------------------------------------

class ShardedSortOut(NamedTuple):
    values: torch.Tensor       # (n_shards * capacity,) ascending among valid
    valid: torch.Tensor        # (n_shards * capacity,)
    dropped: torch.Tensor


def sharded_sample_sort(x: torch.Tensor, group, oversample: int = 8,
                        slack: float = 2.0) -> ShardedSortOut:
    """Distributed sample sort over one group (every rank the same local
    size):

    1. local sort;
    2. every rank contributes ``oversample`` evenly spaced local samples,
       all-gathered into the replicated pivot frontier;
    3. a searchsorted buckets each item by rank;
    4. an all-to-all shuffle with per-pair capacity
       ``slack * n_local / n_shards + 1``;
    5. a local sort of the received buffer.

    Rank i holds the keys of pivot range i, the valid ones first."""
    n_local = x.shape[0]
    n_shards = dist.get_world_size(group)
    xs = torch.sort(x).values
    step = max(1, n_local // oversample)
    samples = xs[::step][:oversample]
    pivots = torch.sort(all_gather(samples, group)).values
    k = pivots.shape[0]
    splitter_idx = (torch.arange(1, n_shards, device=x.device) * k) // n_shards
    splitters = pivots[splitter_idx]
    bucket = torch.searchsorted(splitters, xs, right=True).to(torch.int32)
    cap = int(slack * n_local / max(1, n_shards)) + 1
    out = shuffle_alltoall(bucket, xs, group, capacity=cap)
    vals = out.payload.reshape(-1)
    mask = out.valid.reshape(-1)
    big = (torch.finfo(x.dtype).max if x.dtype.is_floating_point
           else torch.iinfo(x.dtype).max)
    filled = torch.where(mask, vals, big)
    order = torch.argsort(filled, stable=True)
    return ShardedSortOut(values=filled[order], valid=mask[order],
                          dropped=out.dropped)


__all__ = [
    "ShuffleOut", "shuffle_alltoall", "keyed_hop", "funnel_allreduce",
    "segment_scatter_add", "AttnPartial", "softmax_merge_pair",
    "softmax_merge_axis", "ShardedSortOut", "sharded_sample_sort",
    "all_to_all", "all_gather", "all_reduce", "reduce_scatter",
    "copy_to_region", "reduce_from_region", "gather_from_region",
    "gather_along", "scale_grad", "fsdp_gather", "COLLECTIVE_OPS",
    "all_reduce_", "all_gather_into", "reduce_scatter_into",
    "all_to_all_into", "permute",
]

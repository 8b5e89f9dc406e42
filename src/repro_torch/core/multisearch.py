"""Multi-searching (paper §4.1, Theorem 4.1, and Appendix A brute force).

N queries are routed through a search DAG built over the sorted pivots.  The
paper's DAG (from Goodrich's BSP multisearch) has O(log_M N) levels with
O(N / log_M N) nodes per level; congestion is controlled by splitting the
queries into K = log_M N random batches and pipelining them: batch i enters
the sources at round i, so every level processes one batch per round and
each node sees at most M queries per round w.h.p.

Here: an (M/2)-ary search tree over the pivots, run level-synchronously with
explicit batches; per-round per-node congestion is measured and reported
(the w.h.p. claim), and rounds and communication are accounted.  The answer
equals ``searchsorted(pivots, queries, side="left")``.

One level of descent counts, for a query at tree node k, the child-subtree
maxima below the query.  The f maxima of node k are non-decreasing in the
child index (the padded pivots are sorted), so the count is one
``torch.searchsorted`` of the query into node k's row of maxima, with no
(nodes, capacity, f) comparison tensor.

:func:`multisearch_opt` is the one-call counterpart.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .costmodel import CostAccum, MRCost, log_M, tree_height
from .mrmodel import scatter_or_drop
from .plan import (Plan, account_stage, dtype_max, dtype_name, entry_stage,
                   round_stage, torch_dtype)
from .prefix import random_indexing


class MultisearchResult(NamedTuple):
    buckets: torch.Tensor       # (n_queries,) index in [0, n_pivots]
    max_congestion: int         # max queries at any tree node in any round
    rounds: int


class EngineSearchResult(NamedTuple):
    """Output of the engine-driven multisearch."""

    buckets: torch.Tensor       # (n_queries,) index in [0, n_pivots]
    stats: CostAccum


def _padded_pivots(pivots: torch.Tensor, pad: int) -> torch.Tensor:
    """Sorted pivots followed by ``pad`` copies of the dtype's maximum,
    along the last axis (leading axes are queries of a batch)."""
    return torch.cat([torch.sort(pivots, dim=-1).values,
                      torch.full(pivots.shape[:-1] + (pad,),
                                 dtype_max(pivots.dtype),
                                 dtype=pivots.dtype, device=pivots.device)],
                     dim=-1)


def _child_index(q: torch.Tensor, padded: torch.Tensor, k: torch.Tensor,
                 stride: torch.Tensor, f: int) -> torch.Tensor:
    """The child c in [0, f) of tree node k that each query descends to:
    the number of child-subtree maxima below the query, capped at f - 1.

    ``q`` is (..., rows, cols) and ``padded`` (..., n_padded), with the
    same leading (batch) axes; ``k`` and ``stride`` (leaves under one
    child) are (rows,), one node per row.  The maximum under child k*f + j
    is ``padded[..., (k*f + j + 1) * stride - 1]``; rows are non-decreasing
    in j, so the count is a left-sided searchsorted.  A NaN query counts
    no maximum below it, as the JAX package's ``sum(q > bounds)`` does,
    where a searchsorted would place it after every bound."""
    j = torch.arange(f, device=q.device, dtype=torch.int64)
    bound_idx = ((k.long()[:, None] * f + j + 1) * stride.long()[:, None]
                 - 1).clamp(0, padded.shape[-1] - 1)
    bounds = padded[..., bound_idx]
    dt = torch.promote_types(q.dtype, bounds.dtype)
    c = torch.searchsorted(bounds.to(dt).contiguous(), q.to(dt).contiguous(),
                           side="left", out_int32=True)
    if q.is_floating_point():
        c = torch.where(torch.isnan(q), 0, c)
    return c.clamp_max(f - 1)


def multisearch(queries: torch.Tensor, pivots: torch.Tensor, M: int,
                key=None, cost: Optional[MRCost] = None,
                pipelined: bool = True) -> MultisearchResult:
    """Theorem 4.1: route all queries through the pivot search tree.

    Returns bucket b per query with pivots[b-1] < q <= pivots[b] (i.e.
    ``searchsorted(pivots, q, side='left')``), the measured per-node
    congestion, and the number of rounds taken.  ``key`` (an int seed, a
    ``torch.Generator`` or the (n_queries,) int32 slots; default seed 0)
    draws the random batches, on the queries' device.
    """
    queries, pivots = torch.as_tensor(queries), torch.as_tensor(pivots)
    dev = queries.device
    n_q = queries.shape[0]
    m = pivots.shape[0]
    n = n_q + m
    f = max(2, M // 2)
    L = tree_height(max(m, 2), f)
    padded = _padded_pivots(pivots.to(dev), f ** L - m)

    # Random batching (the congestion-control half of Thm 4.1).
    K = max(1, log_M(n, max(2, M))) if pipelined else 1
    if key is None:
        key = 0
    if pipelined and n_q > 1:
        idx = random_indexing(n_q, key, M, cost=cost, device=dev)
        batch = (idx.long() * K) // n_q            # K near-equal batches
    else:
        batch = torch.zeros((n_q,), dtype=torch.int64, device=dev)

    node = torch.zeros((n_q,), dtype=torch.int64, device=dev)  # at the root
    level = -batch                                 # batch i enters at round i
    max_cong = torch.zeros((), dtype=torch.int32, device=dev)
    accum = CostAccum.zero(dev)
    total_rounds = L + K - 1
    for r in range(total_rounds):
        active = (level >= 0) & (level < L)
        # each query descends from its own level: the stride of a node at
        # level l is f^(L - l - 1)
        lvl = level.clamp(0, L - 1)
        stride = torch.tensor([f ** (L - l - 1) for l in range(L)],
                              dtype=torch.int64, device=dev)[lvl]
        moved = node * f + _child_index(queries[:, None], padded, node,
                                        stride, f)[:, 0]
        node = torch.where(active, moved, node)
        # congestion: queries per (level, node) among the active ones, one
        # bincount over the L f^L (level, node) bins; inactive queries
        # count into a sentinel bin, cut off
        n_bins = L * f ** L
        cong_key = torch.where(active, level * (f ** L) + node, n_bins)
        round_cong = torch.bincount(cong_key, minlength=n_bins + 1)[
            :n_bins].max().to(torch.int32)
        max_cong = torch.maximum(max_cong, round_cong)
        level = level + 1
        accum = accum.add_round(
            items_sent=active.sum() + m,
            max_io=round_cong.clamp_min(1).clamp_max(M))
    if cost is not None:
        cost.absorb(accum)                          # one host sync, at the end

    buckets = node.clamp_max(m).to(torch.int32)     # leaf index, padded tree
    # queries beyond the largest pivot belong to the past-the-end bucket m
    # (when m == f^L the tree has no padding leaf to express this)
    buckets = torch.where(queries > padded[m - 1], m, buckets)
    return MultisearchResult(buckets=buckets.to(torch.int32),
                             max_congestion=int(max_cong),
                             rounds=total_rounds)


def multisearch_plan(n_queries: int, n_pivots: int, M: int, *,
                     dtype=torch.float32, capacity: Optional[int] = None,
                     pipelined: bool = True, align=None,
                     shape: bool = True) -> Plan:
    """Theorem 4.1 as a plan builder.

    The search tree is laid out as mailbox nodes: K batch-source nodes
    [0, K), then tree level l at offset T_l (root = node K, leaves at level
    L).  Batch b waits at source node b and enters the root at round b; a
    query at level l < L descends one level per round by the implicit f-ary
    index arithmetic; leaves keep.  After K + L rounds every query sits at
    the leaf naming its bucket.  The layout, K, L and every capacity depend
    only on (n_queries, n_pivots, M); ``(queries, pivots)`` arrive at
    execute time.

    ``capacity`` defaults to n_queries (lossless).  At capacity ~ M the
    per-node congestion is w.h.p. <= M thanks to the random batching (PRNG
    slot ``"batches"``: an int seed, a ``torch.Generator`` or the
    (n_queries,) int32 slots of :func:`~repro_torch.core.prefix.
    random_indexing`), and ``stats.dropped`` reports the w.h.p. failure
    event.

    ``shape=True`` shape-schedules the warm-up: before round r nothing can
    occupy levels deeper than r, so the entry mailbox holds the K sources
    only and round r's footprint is T[r+1] nodes until the pipeline reaches
    the leaves at round L; the remaining K rounds run at the full V.
    ``shape=False`` keeps every round at (V, capacity).  Bit-identical
    either way.
    """
    n_q, m, M = int(n_queries), int(n_pivots), int(M)
    n = n_q + m
    dtype = torch_dtype(dtype)
    f_br = max(2, M // 2)
    L = tree_height(max(m, 2), f_br)
    pad = f_br ** L - m
    K = max(1, log_M(n, max(2, M))) if pipelined else 1
    # Node layout: sources [0, K); tree level l occupies [T[l], T[l] + f^l).
    T = [K + (f_br ** l - 1) // (f_br - 1) for l in range(L + 1)]
    V = T[L] + f_br ** L
    if align is not None:
        V = int(align(V))
    cap = int(capacity) if capacity is not None else max(1, n_q)
    fingerprint = ("multisearch", n_q, m, M, dtype_name(dtype), cap, pipelined, V,
                   bool(shape))

    def prologue(inputs, keys, device):
        queries = torch.as_tensor(inputs[0], device=device)
        pivots = torch.as_tensor(inputs[1], device=device)
        padded = _padded_pivots(pivots, pad)
        if pipelined and n_q > 1:
            # one draw per query of the batch, from its own key
            idx = torch.stack([random_indexing(n_q, k["batches"], M,
                                               device=device) for k in keys])
            batch = ((idx.long() * K) // n_q).to(torch.int32)
        else:
            batch = torch.zeros((len(keys), n_q), dtype=torch.int32,
                                device=device)
        return {"queries": queries, "padded": padded, "batch": batch}

    # Per node id: its tree level (-1 for sources, L for leaves and the
    # aligned tail), the node's index within its level and its stride.
    bounds_t = torch.tensor(T, dtype=torch.int64)
    strides = torch.tensor([f_br ** (L - l - 1) for l in range(L)] + [1],
                           dtype=torch.int64)

    def make_step(offset: int):
        # ``offset`` is the global round index of the stage's first round:
        # the shape-scheduled plan splits the descent into per-round
        # stages, so the source-release clock offset + r keeps counting
        # across stage boundaries.
        def make_fn(carry):
            padded = carry["padded"]

            def step(r, ids, b):
                q, qi = b.payload
                tl = bounds_t.to(ids.device)
                level = torch.searchsorted(tl, ids.long(), right=True) - 1
                in_tree = (level >= 0) & (level < L)
                lvl = level.clamp(0, L)
                k_local = ids.long() - tl[lvl]
                c = _child_index(q, padded, k_local,
                                 strides.to(ids.device)[lvl], f_br)
                # per node: its first child's id, or itself (sources, leaves)
                first = torch.where(in_tree,
                                    tl[(lvl + 1).clamp_max(L)]
                                    + k_local * f_br, ids.long())
                dest = first.to(torch.int32)[:, None] + torch.where(
                    in_tree[:, None], c, 0)          # (B, V, cap)
                # source b releases its batch into the root at round b
                release = torch.where(ids == offset + r, T[0], ids)
                dest = torch.where((ids < K)[:, None], release[:, None],
                                   dest)
                dest = torch.where(b.valid, dest, -1)
                return dest.to(torch.int32), (q, qi)
            return step
        return make_fn

    def emit_entry(c):
        batch = c["batch"]
        return (batch, (c["queries"],
                        torch.arange(n_q, dtype=torch.int32,
                                     device=batch.device).expand(batch.shape)))

    if shape:
        # Warm-up rounds r < L reach at most tree level r: footprint T[r+1]
        # = end of level r's range (prefix-ordered layout, so destination
        # ids are unchanged).  Steady state: K rounds at V.
        stages = [entry_stage("entry", K, cap, emit_entry)]
        # early_dests: descent targets are child ids in the static
        # prefix-ordered tree layout (the tree is carry).
        stages += [round_stage(f"descend-{r}", make_step(r), 1,
                               n_nodes=T[r + 1], early_dests=True)
                   for r in range(L)]
        stages.append(round_stage("descend-steady", make_step(L), K,
                                  n_nodes=V, early_dests=True))
        stages.append(account_stage("output", ((n_q, 1),)))
        stages = tuple(stages)
    else:
        stages = (
            # Entry round: query j is thrown into its batch's source node.
            entry_stage("entry", V, cap, emit_entry),
            round_stage("descend", make_step(0), K + L, early_dests=True),
            account_stage("output", ((n_q, 1),)),
        )

    def epilogue(state):
        # Leaves -> output: scatter each query's leaf index by original id.
        box, carry = state.box, state.carry
        q, qi = box.payload
        valid = box.valid
        dev = valid.device
        B = valid.shape[0]
        ids2 = torch.arange(valid.shape[-2], dtype=torch.int64,
                            device=dev)[:, None]
        at_leaf = valid & (ids2 >= T[L])
        leaf_k = (ids2 - T[L]).clamp_max(m).to(torch.int32)
        row = torch.arange(B, device=dev)[:, None, None] * n_q
        buckets = scatter_or_drop(
            torch.zeros((B * n_q,), dtype=torch.int32, device=dev),
            (qi + row).reshape(-1), at_leaf.reshape(-1),
            leaf_k.expand(valid.shape).reshape(-1),
            torch.arange(valid.numel(), device=dev)).view(B, n_q)
        buckets = torch.where(carry["queries"]
                              > carry["padded"][:, m - 1:m], m, buckets)
        return EngineSearchResult(buckets=buckets.to(torch.int32),
                                  stats=state.accum)

    return Plan(name="multisearch", fingerprint=fingerprint, n_nodes=V,
                stages=stages, prologue=prologue, epilogue=epilogue,
                round_bound=1 + K + L + 1,
                prng_slots=("batches",), default_seed=0,
                input_spec=(((n_q,), None), ((m,), dtype)))


def multisearch_mr(queries, pivots, M: int, *, engine=None, key=None,
                   capacity: Optional[int] = None,
                   pipelined: bool = True) -> EngineSearchResult:
    """Deprecated wrapper over :func:`multisearch_plan`: builds the plan,
    compiles it on ``engine`` (cached per fingerprint) and runs it on
    ``(queries, pivots)``.  Prefer the plan API (repro_torch.core.api)."""
    from .api import deprecated_entry
    deprecated_entry("multisearch_mr", "multisearch_plan")
    if engine is None:
        from .engine import default_engine
        engine = default_engine()
    queries = torch.as_tensor(queries)
    pivots = torch.as_tensor(pivots)
    plan = multisearch_plan(queries.shape[0], pivots.shape[0], M,
                            dtype=pivots.dtype, capacity=capacity,
                            pipelined=pipelined,
                            align=engine.aligned_nodes)
    return engine.compile(plan)(queries, pivots, key=key)


def multisearch_opt(queries: torch.Tensor, pivots: torch.Tensor
                    ) -> torch.Tensor:
    """Optimized counterpart: one ``torch.searchsorted`` over the sorted
    pivots."""
    queries, pivots = torch.as_tensor(queries), torch.as_tensor(pivots)
    return torch.searchsorted(torch.sort(pivots).values, queries,
                              side="left").to(torch.int32)


def brute_force_multisearch(queries: torch.Tensor, pivots: torch.Tensor,
                            M: int, cost: Optional[MRCost] = None
                            ) -> torch.Tensor:
    """Appendix A: all-pairs comparison over nodes v_{i,j}.

    k_i = |{j : y_j < x_i}| computed by materializing comparisons in M x M
    tiles (the nodes), then summing each row with the Lemma 2.2 bottom-up
    phase.  O(n*m) communication, O(log_M) replication rounds.
    """
    queries, pivots = torch.as_tensor(queries), torch.as_tensor(pivots)
    n, m = queries.shape[0], pivots.shape[0]
    ps = torch.sort(pivots).values
    ranks = torch.zeros((n,), dtype=torch.int32, device=queries.device)
    tile = max(2, M)
    n_row_tiles = math.ceil(n / tile)
    n_col_tiles = math.ceil(m / tile)
    for bi in range(n_row_tiles):
        qs = queries[bi * tile:(bi + 1) * tile]
        acc = torch.zeros((qs.shape[0],), dtype=torch.int32,
                          device=queries.device)
        for bj in range(n_col_tiles):
            ys = ps[bj * tile:(bj + 1) * tile]
            acc = acc + (qs[:, None] > ys[None, :]).sum(1, dtype=torch.int32)
        ranks[bi * tile:(bi + 1) * tile] = acc
    if cost is not None:
        # replication of x over column tiles and y over row tiles (App A)
        repl_rounds = max(1, log_M(max(n_col_tiles, 2), max(2, M)))
        for _ in range(repl_rounds):
            cost.round(items_sent=n * n_col_tiles + m * n_row_tiles, max_io=M)
        cost.round(items_sent=n * n_col_tiles + m * n_row_tiles, max_io=M)
        # add-up phase (bottom-up tree over column tiles)
        for _ in range(max(1, log_M(max(n_col_tiles, 2), max(2, M)))):
            cost.round(items_sent=n * n_col_tiles, max_io=M)
    return ranks

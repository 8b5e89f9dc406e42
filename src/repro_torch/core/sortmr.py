"""Sorting in the MapReduce model (paper §4.3 and Lemma 4.3 / Appendix A).

``brute_force_sort``: every pair of items is compared at a (tiled) node
v_{i,j}; summing each row of the comparison matrix yields each item's rank.
O(log_M N) rounds but O(N^2 log_M N) communication — only viable for small
inputs, which is exactly how §4.3 uses it: on the Theta(sqrt(N)) pivots.

``sort_plan`` is the paper's §4.3 sample sort as a *plan builder*: the
static radix schedule — pivot-sort accounting, entry shuffle,
bucket-refinement rounds, reducer-local sort — is emitted as a declarative
:class:`~repro_torch.core.plan.Plan` from (n, M) alone, bound once per
backend through ``engine.compile(plan)`` and executed on data.

The splitter sample is the one random draw.  Its slot ``"splitters"`` takes
an int seed, a ``torch.Generator`` (the sample is the first s entries of a
``torch.randperm`` drawn from it), or the sample indices themselves — which
is how the tests hand the port the JAX package's own draw, so per-round
costs agree exactly.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .costmodel import CostAccum, MRCost, log_M
from .plan import (Plan, account_stage, dtype_max, dtype_name, entry_stage,
                   round_stage, torch_dtype)


def brute_force_sort(x: torch.Tensor, M: int,
                     cost: Optional[MRCost] = None) -> torch.Tensor:
    """Lemma 4.3: rank by all-pairs comparison, then permute by rank.

    Stable: ties are broken by input index (the paper assumes an indexed
    collection; index = position)."""
    n = x.shape[0]
    tile = max(2, M)
    n_tiles = math.ceil(n / tile)
    idx = torch.arange(n, device=x.device)
    ranks = torch.zeros((n,), dtype=torch.int64, device=x.device)
    for bi in range(n_tiles):
        sl = slice(bi * tile, min((bi + 1) * tile, n))
        xi, ii = x[sl], idx[sl]
        acc = torch.zeros((xi.shape[0],), dtype=torch.int64, device=x.device)
        for bj in range(n_tiles):
            sj = slice(bj * tile, min((bj + 1) * tile, n))
            xj, ij = x[sj], idx[sj]
            less = xj[None, :] < xi[:, None]
            tie = (xj[None, :] == xi[:, None]) & (ij[None, :] < ii[:, None])
            acc = acc + (less | tie).sum(1)
        ranks[sl] = acc
    out = torch.zeros_like(x)
    out[ranks] = x
    if cost is not None:
        repl = max(1, log_M(max(n_tiles, 2), max(2, M)))
        for _ in range(repl):                       # replicate rows+cols
            cost.round(items_sent=2 * n * n_tiles, max_io=M)
        cost.round(items_sent=n * n_tiles, max_io=M)        # compare
        for _ in range(max(1, log_M(max(n_tiles, 2), max(2, M)))):
            cost.round(items_sent=n * n_tiles, max_io=M)    # row-sum tree
        cost.round(items_sent=n, max_io=1)                  # permute by rank
    return out


def sample_sort(x, M: int, key=None, cost: Optional[MRCost] = None,
                _depth: int = 0) -> torch.Tensor:
    """Deprecated: the §4.3 sample sort as one call.

    Delegates to :func:`sort_plan_escalating` on the default engine, which
    handles the w.h.p. overflow event as the paper does, by retrying with
    more capacity.  ``cost`` absorbs the plan's functional accounting;
    ``_depth`` is accepted for compatibility and ignored."""
    from .api import deprecated_entry
    deprecated_entry("sample_sort", "sort_plan")
    res = sort_plan_escalating(x, M, key=key)
    if cost is not None:
        cost.absorb(res.stats)
    return res.values


def sort_plan_escalating(x, M: int, *, key=None,
                         engine=None) -> "EngineSortResult":
    """Run the sort plan, retrying the w.h.p. drop event with more capacity
    the way the paper does: defaults -> generous slack -> one reducer
    (cap >= n, cannot drop).  Host-level: reads ``stats.dropped``."""
    if engine is None:
        from .engine import default_engine
        engine = default_engine()
    x = torch.as_tensor(x)
    n = x.shape[0]
    for slack, n_nodes in ((3.0, None), (8.0, None), (1.0, 1)):
        plan = sort_plan(n, M, dtype=x.dtype, slack=slack, n_nodes=n_nodes,
                         align=engine.aligned_nodes)
        res = engine.compile(plan)(x, key=key)
        if int(res.stats.dropped) == 0:
            break
    return res


class EngineSortResult(NamedTuple):
    """Output of the engine-driven sample sort."""

    values: torch.Tensor         # (n,) ascending — valid iff stats.dropped == 0
    stats: CostAccum


def pivot_sample_size(n: int, n_buckets: int, oversample: int) -> int:
    """Static Theta(n_buckets * oversample) sample size of the §4.3 pivot
    stage, shared by :func:`quantile_splitters` and the plan's pivot-sort
    accounting so declared schedules cannot drift from execution."""
    return int(min(n, max(2, n_buckets * oversample)))


def sample_indices(key, n: int, s: int, device) -> torch.Tensor:
    """The s sample positions a splitter slot's key stands for: the first s
    of a permutation of range(n) drawn from an int seed or a
    ``torch.Generator``, or the given integer indices (at least s)."""
    if isinstance(key, torch.Generator):
        perm = torch.randperm(n, generator=key, device=key.device)
    elif isinstance(key, (int, np.integer)):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(key))
        perm = torch.randperm(n, generator=gen, device=device)
    else:
        perm = torch.as_tensor(np.array(key) if not isinstance(
            key, torch.Tensor) else key)
        if perm.ndim != 1 or perm.dtype.is_floating_point \
                or perm.dtype == torch.bool:
            raise ValueError("sample indices must be a 1-D integer array, "
                             f"got {perm.dtype} of shape {tuple(perm.shape)}")
        if perm.shape[0] < s:
            raise ValueError(f"need at least {s} sample indices, "
                             f"got {perm.shape[0]}")
    return perm[:s].to(device=device, dtype=torch.int64)


def quantile_splitters(x: torch.Tensor, n_buckets: int, oversample: int,
                       key) -> Tuple[torch.Tensor, int]:
    """§4.3 pivot stage: the ``n_buckets - 1`` sample-quantile splitters of a
    Theta(n_buckets * oversample) random sample of ``x``.

    Returns (splitters ascending, sample size s); ``key`` is read as
    :func:`sample_indices` reads it."""
    splitters, s = batch_splitters(x[None], n_buckets, oversample, [key])
    return splitters[0], s


def batch_splitters(x: torch.Tensor, n_buckets: int, oversample: int,
                    keys) -> Tuple[torch.Tensor, int]:
    """:func:`quantile_splitters` of B queries at once: ``x`` (B, n), one
    key per query in ``keys``, splitters (B, n_buckets - 1).  Each query's
    sample positions are drawn from its own key (the one draw made per
    query); the gather and the sort run once for the batch."""
    n = x.shape[-1]
    s = pivot_sample_size(n, n_buckets, oversample)
    idx = torch.stack([sample_indices(k, n, s, x.device) for k in keys])
    sample = torch.sort(torch.gather(x, -1, idx), dim=-1).values
    q = (torch.arange(1, n_buckets, device=x.device) * s) // n_buckets
    return sample[:, q], s


def sort_plan(n: int, M: int, *, dtype=torch.float32, levels: int = 1,
              oversample: int = 8, slack: float = 3.0,
              n_nodes: Optional[int] = None, align=None,
              shape: bool = True) -> Plan:
    """§4.3 sample sort as a plan builder.

    The recursion is flattened into a static radix schedule of ``levels``
    bucket-refinement rounds: with V reducers and branching
    B = V^(1/levels), round d routes every item to the leader of its
    B^(levels-1-d)-wide bucket group, so items converge to their final
    bucket in ``levels`` shuffles; one reducer-local sort round (the "keep"
    primitive) then orders each bucket.  Splitters are the V-1 sample
    quantiles of a Theta(V * oversample) random sample — the paper's pivot
    stage, accounted as its O(log_M) rounds.

    Everything here is static, so the plan is built without touching data;
    inputs ``(x,)`` arrive at execute time and move to the engine's device.
    The result is valid iff ``stats.dropped == 0`` (the paper's w.h.p.
    event — raise ``slack`` or ``oversample`` if it fires).  ``shape=True``
    shape-schedules the refine ladder: level d runs in a mailbox of
    V_d = min(V, B^(d+1)) compactly numbered group nodes.
    """
    n, M = int(n), int(M)
    dtype = torch_dtype(dtype)
    if n <= 1:
        return Plan(
            name="sort", fingerprint=("sort-trivial", n, dtype_name(dtype)),
            n_nodes=1, stages=(),
            prologue=lambda inputs, keys, device: {
                "x": torch.as_tensor(inputs[0], device=device)},
            epilogue=lambda st: EngineSortResult(values=st.carry["x"],
                                                 stats=st.accum),
            round_bound=0, input_spec=(((n,), dtype),))
    levels = max(1, int(levels))
    M_eff = max(2, M)
    if n_nodes is not None:
        V = int(n_nodes)
    else:
        V = max(1, -(-n // M_eff))
        if align is not None:
            V = int(align(V))
    B = max(2, math.ceil(V ** (1.0 / levels))) if V > 1 else 1
    s = pivot_sample_size(n, V, oversample)       # static, = runtime sample
    piv_rounds = max(1, log_M(max(s, 2), M_eff))
    fingerprint = ("sort", n, M, dtype_name(dtype), levels, oversample,
                   float(slack), V, bool(shape))

    def group_nodes(d):
        return min(V, B ** (d + 1))

    def group_cap(d):
        return max(1, int(math.ceil(slack * n / group_nodes(d))))

    def bucket_of(splitters, v):
        # splitters (B, V-1), values (B, ...): each query searches its own
        b = torch.searchsorted(splitters, v.reshape(v.shape[0], -1),
                               side="left").view(v.shape)
        return b.clamp(0, V - 1).to(torch.int32)

    def level_dest(splitters, vals, valid, d):
        # Frozen numbering sends bucket group g to its leader node
        # g * width; the shape-scheduled ladder numbers level d's live
        # groups compactly (node g = group g).  Same grouping either way.
        width = B ** (levels - 1 - d)
        group = bucket_of(splitters, vals) // width
        dest = group if shape else group * width
        return torch.where(valid, dest, -1)

    def prologue(inputs, keys, device):
        x = torch.as_tensor(inputs[0], device=device)
        splitters, _ = batch_splitters(x, V, oversample,
                                       [k["splitters"] for k in keys])
        return {"x": x, "splitters": splitters}

    stages = [
        # pivot sort: O(log_M s) rounds moving the s samples
        account_stage("pivot-sort", ((s, min(s, M_eff)),) * piv_rounds),
        # level 0 routes straight from the input collection
        entry_stage("entry", group_nodes(0) if shape else V, group_cap(0),
                    lambda c: (level_dest(c["splitters"], c["x"],
                                          torch.ones_like(c["x"],
                                                          dtype=torch.bool),
                                          0),
                               c["x"])),
    ]
    for d in range(1, levels):
        def make_refine(carry, _d=d):
            spl = carry["splitters"]

            def refine(r, ids, b):
                return level_dest(spl, b.payload, b.valid, _d), b.payload
            return refine
        # early_dests as the JAX package declares it: the refine ladder's
        # group targets come from the static level schedule (the splitters
        # are carry), though the level reads the payload.
        stages.append(round_stage(f"refine-{d}", make_refine, 1,
                                  capacity=group_cap(d),
                                  n_nodes=group_nodes(d) if shape else None,
                                  early_dests=True))

    big = dtype_max(dtype)

    def make_local_sort(carry):
        # Reducer-local sort round: sort within the mailbox, keep at self.
        def local_sort(r, ids, b):
            svals = torch.sort(b.payload.masked_fill(~b.valid, big),
                               dim=-1).values
            count = b.valid.sum(-1, keepdim=True)
            slot = torch.arange(svals.shape[-1], device=svals.device)
            dest = torch.where(slot < count, ids[:, None], -1)
            return dest, svals
        return local_sort

    stages.append(round_stage("local-sort", make_local_sort, 1,
                              early_dests=True))   # keep-at-self dests
    stages.append(account_stage("output", ((n, 1),)))   # leaves -> output

    def epilogue(state):
        # Output assembly: bucket-major compaction (valid slots are a FIFO
        # prefix per node, so position = bucket offset + slot).  Slots past
        # the output go to one extra position, cut off (no drop-mode
        # scatter in PyTorch).
        box = state.box
        B = box.valid.shape[0]
        counts = box.valid.sum(-1)
        offsets = torch.cumsum(counts, -1) - counts
        slot = torch.arange(box.valid.shape[-1], device=counts.device)
        pos = torch.where(box.valid, offsets[..., None] + slot,
                          n).clamp_max(n)
        row = torch.arange(B, device=counts.device)[:, None, None] * (n + 1)
        out = torch.zeros((B, n + 1), dtype=dtype, device=counts.device)
        out.view(-1)[(pos + row).reshape(-1)] = box.payload.reshape(-1)
        return EngineSortResult(values=out[:, :n], stats=state.accum)

    return Plan(name="sort", fingerprint=fingerprint, n_nodes=V,
                stages=tuple(stages), prologue=prologue, epilogue=epilogue,
                round_bound=piv_rounds + levels + 2,
                prng_slots=("splitters",), default_seed=7,
                input_spec=(((n,), dtype),))


def sample_sort_mr(x, M: int, *, engine=None, key=None,
                   n_nodes: Optional[int] = None,
                   levels: int = 1, oversample: int = 8,
                   slack: float = 3.0) -> EngineSortResult:
    """Deprecated wrapper over :func:`sort_plan`: builds the plan, compiles
    it on ``engine`` (cached per fingerprint) and runs it on ``x``."""
    from .api import deprecated_entry
    deprecated_entry("sample_sort_mr", "sort_plan")
    if engine is None:
        from .engine import default_engine
        engine = default_engine()
    x = torch.as_tensor(x)
    plan = sort_plan(x.shape[0], M, dtype=x.dtype, levels=levels,
                     oversample=oversample, slack=slack, n_nodes=n_nodes,
                     align=engine.aligned_nodes)
    return engine.compile(plan)(x, key=key)


def sort_opt(x: torch.Tensor) -> torch.Tensor:
    """Optimized counterpart: the library's on-device sort."""
    return torch.sort(torch.as_tensor(x)).values


def sort_cost_bound(n: int, M: int) -> Tuple[int, int]:
    """Paper bound for sample sort as the unit scale: (log_M n,
    n * log_M n) — O(log_M N) rounds, O(N log_M N) words."""
    return log_M(n, M), n * log_M(n, M)

"""All-prefix-sums and random indexing (paper §2.1, Lemmas 2.2 and 2.3).

The d-ary tree T with branching factor d = M/2 and height L = ceil(log_d N),
run level by level as the paper's bottom-up and top-down phases, with round
and communication accounting.  The level tensors are the per-level node
states; routing between levels is index arithmetic on the implicit labels
v = (l, k) (parent p(v) = (l-1, floor(k/d)), j-th child w_j = (l+1, k*d + j)).

:func:`prefix_sum_opt` is the one-call counterpart, ``torch.cumsum``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._device import as_device
from .costmodel import CostAccum, MRCost, tree_height
from .plan import (Plan, account_stage, dtype_name, entry_stage, round_stage,
                   torch_dtype)


def _row_sums(x: torch.Tensor) -> torch.Tensor:
    """Sum of each row of a (..., rows, d) tensor in its own dtype (int32
    wraps as in the JAX package).  Both the physical plan's level sums and
    its bottom-up mailbox rounds sum through here, so they agree bit for
    bit."""
    return torch.sum(x, dim=-1, dtype=x.dtype)


def _excl_rows(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix along the rows of a (..., rows, d) tensor, own
    dtype."""
    return torch.cumsum(x, dim=-1, dtype=x.dtype) - x


def _pad_groups(x: torch.Tensor, n_groups: int, d: int) -> torch.Tensor:
    """``x`` (..., n) zero-padded to ``n_groups * d`` items, as (...,
    n_groups, d)."""
    pad = n_groups * d - x.shape[-1]
    if pad:
        x = torch.cat([x, torch.zeros(x.shape[:-1] + (pad,), dtype=x.dtype,
                                      device=x.device)], dim=-1)
    return x.reshape(x.shape[:-1] + (n_groups, d))


class PrefixResult(NamedTuple):
    """Output of the prefix-sums plan."""

    values: torch.Tensor
    stats: CostAccum


def prefix_plan(n: int, M: int, *, dtype=torch.int32,
                inclusive: bool = True, physical: bool = False,
                shape: bool = True) -> Plan:
    """Lemma 2.2 all-prefix-sums as a plan builder, d = M/2.

    The round schedule — 1 (input -> leaves) + (L-1) bottom-up + L top-down
    + 1 (output) = O(log_M N) rounds, with per-round communication that
    depends only on (n, M) — is static, so the stage table carries the
    exact accounting while the prologue runs the dense level-by-level tree
    on the data (``(values,)`` at execute time).

    ``physical=True`` runs the tree as engine rounds instead: the entry
    shuffle groups d items per leaf-parent node, each bottom-up round sums
    a mailbox row and routes the subtree sum to its parent ``ids // d``, and
    each top-down round fans a node's offset out to its d children (child
    exclusive prefixes come from the carry's level sums).  ``shape=True``
    runs every level in its own mailbox of ceil(n/d^(l+1)) nodes;
    ``shape=False`` keeps the entry footprint (ceil(n/d), d) throughout.
    The two are bit-identical in outputs and per-round stats.
    """
    n, M = int(n), int(M)
    dtype = torch_dtype(dtype)
    d = max(2, M // 2)
    L = tree_height(max(n, 2), d)
    if physical:
        return _physical_prefix_plan(n, M, d, dtype, inclusive, shape)
    fingerprint = ("prefix", n, M, dtype_name(dtype), bool(inclusive))

    # Static accounting: only non-empty nodes communicate (implicit tree).
    up_costs = []
    occupied = n                                  # non-empty nodes this level
    for _ in range(L - 1):
        up_costs.append((occupied + n, d))
        occupied = -(-occupied // d)
    down_costs = []
    for l in range(L):
        width = d ** (l + 1)                      # offsets width after fanout
        occ = min(width, -(-n // d ** (L - 1 - l)) * d, 2 * n)
        down_costs.append((occ + n, d))

    def prologue(inputs, keys, device):
        values = torch.as_tensor(inputs[0], device=device)
        B = values.shape[0]
        # d^L leaves: at most d times n, since L = ceil(log_d n)
        leaves = _pad_groups(values, d ** (L - 1), d).reshape(B, -1)
        # Bottom-up phase: levels[i] = subtree sums of the nodes at tree
        # level L-1-i; each step is one MR round (node v sends s_v to its
        # parent).
        levels = [leaves]
        for _ in range(L - 1):
            levels.append(_row_sums(levels[-1].reshape(B, -1, d)))
        # Top-down phase: offsets[k] = sum of all leaves strictly left of
        # node k's subtree at the current level.
        offsets = torch.zeros((B, 1), dtype=leaves.dtype, device=device)
        for l in range(L):
            child_sums = levels[L - 1 - l].reshape(B, -1, d)
            offsets = (offsets[..., None]
                       + _excl_rows(child_sums)).reshape(B, -1)
        out = offsets[:, :n] + values if inclusive else offsets[:, :n]
        return {"values": out}

    stages = (
        account_stage("input", ((n, 1),)),        # input node i -> leaf i
        account_stage("bottom-up", tuple(up_costs)),
        account_stage("top-down", tuple(down_costs)),
        account_stage("output", ((n, 1),)),       # leaf k -> a_k + s_{p(v)}
    )

    def epilogue(state):
        return PrefixResult(values=state.carry["values"], stats=state.accum)

    return Plan(name="prefix", fingerprint=fingerprint, n_nodes=d ** L,
                stages=stages, prologue=prologue, epilogue=epilogue,
                round_bound=2 * L + 1, input_spec=(((n,), dtype),))


def _physical_prefix_plan(n: int, M: int, d: int, dtype: torch.dtype,
                          inclusive: bool, shape: bool) -> Plan:
    """Engine-round realization of the Lemma 2.2 tree (see prefix_plan)."""
    if n < 1:
        raise ValueError("physical prefix_plan requires n >= 1")
    # sizes[j] = node count at funnel level j (level 0 = leaf-parents).
    sizes = [-(-n // d)]
    while sizes[-1] > 1:
        sizes.append(-(-sizes[-1] // d))
    J = len(sizes) - 1                     # up rounds beyond the entry
    fingerprint = ("prefix-physical", n, M, dtype_name(dtype), bool(inclusive),
                   bool(shape))

    def prologue(inputs, keys, device):
        values = torch.as_tensor(inputs[0], device=device)
        # Level sums, through the same row sum the bottom-up mailbox rounds
        # use, so the top-down gathers equal the routed sums.
        lv, cur = [], values
        for n_groups in sizes:
            cur = _row_sums(_pad_groups(cur, n_groups, d))
            lv.append(cur)
        return {"values": values, "lv": tuple(lv)}

    def emit_entry(carry):
        vals = carry["values"]
        return (torch.arange(n, dtype=torch.int32,
                             device=vals.device).expand(vals.shape) // d,
                vals)

    def make_up(carry):
        def fn(r, ids, b):
            sums = _row_sums(torch.where(b.valid, b.payload,
                                         torch.zeros_like(b.payload)))
            live = b.valid.any(dim=-1)                   # (B, V)
            slot = torch.arange(b.capacity, dtype=torch.int32,
                                device=ids.device)
            dests = torch.where((slot == 0) & live[..., None],
                                (ids // d)[:, None], -1)
            payload = torch.where(slot == 0, sums[..., None],
                                  torch.zeros_like(sums)[..., None])
            return dests.to(torch.int32), payload
        return fn

    def make_down(j, from_root):
        # Parents at level j+1 fan their offset out to children at level j:
        # child k*d + c receives offset_k + the exclusive prefix of its left
        # siblings' sums (from the carry's level-j sums).
        n_parents, n_children = sizes[j + 1], sizes[j]

        def make_fn(carry):
            excl = _excl_rows(_pad_groups(carry["lv"][j], n_parents, d))

            def fn(r, ids, b):
                B = b.valid.shape[0]
                if from_root:
                    offs = torch.zeros((B, ids.shape[0]), dtype=excl.dtype,
                                       device=ids.device)
                    live = (ids == 0).expand(B, -1)
                else:
                    offs = torch.where(b.valid[..., 0], b.payload[..., 0],
                                       torch.zeros_like(b.payload[..., 0]))
                    live = b.valid[..., 0] & (ids < n_parents)
                rows = ids.clamp(0, n_parents - 1).long()
                col = torch.arange(d, dtype=torch.int32,
                                   device=ids.device)[None, :]
                child = ids[:, None] * d + col
                dests = torch.where(live[..., None] & (child < n_children),
                                    child, -1)
                payload = offs[..., None] + excl[:, rows]
                return dests.to(torch.int32), payload
            return fn
        return make_fn

    stages = [entry_stage("up-0", sizes[0], d, emit_entry)]
    # early_dests: both sweeps address parents and children of the static
    # d-ary tree by node id alone.
    for j in range(1, J + 1):
        stages.append(round_stage(f"up-{j}", make_up, 1, capacity=d,
                                  n_nodes=sizes[j] if shape else None,
                                  early_dests=True))
    for j in range(J - 1, -1, -1):
        stages.append(round_stage(f"down-{j}", make_down(j, j == J - 1), 1,
                                  capacity=1,
                                  n_nodes=sizes[j] if shape else None,
                                  early_dests=True))
    stages.append(account_stage("output", ((n, 1),)))

    def epilogue(state):
        box = state.box
        values = state.carry["values"]
        B = values.shape[0]
        if J == 0:
            group_off = torch.zeros((B, sizes[0]), dtype=values.dtype,
                                    device=values.device)
        else:
            head = box.payload[:, :sizes[0], 0]
            group_off = torch.where(box.valid[:, :sizes[0], 0], head,
                                    torch.zeros_like(head))
        within = _excl_rows(_pad_groups(values, sizes[0], d)).reshape(
            B, -1)[:, :n]
        group = torch.arange(n, device=values.device) // d
        out = group_off[:, group] + within
        if inclusive:
            out = out + values
        return PrefixResult(values=out.to(values.dtype), stats=state.accum)

    return Plan(name="prefix-physical", fingerprint=fingerprint,
                n_nodes=sizes[0], stages=tuple(stages), prologue=prologue,
                epilogue=epilogue, round_bound=2 * J + 2,
                input_spec=(((n,), dtype),))


def tree_prefix_sum(values: torch.Tensor, M: int,
                    cost: Optional[MRCost] = None,
                    inclusive: bool = True) -> torch.Tensor:
    """Deprecated wrapper over :func:`prefix_plan` (Lemma 2.2): builds the
    plan, compiles it on the default engine and runs it, feeding the
    mutable ``cost`` adapter from the plan's functional accounting."""
    from .api import compile_plan, deprecated_entry
    deprecated_entry("tree_prefix_sum", "prefix_plan")
    values = torch.as_tensor(values)
    if values.ndim != 1:
        raise ValueError("tree_prefix_sum expects a 1-D collection of items")
    plan = prefix_plan(values.shape[0], M, dtype=values.dtype,
                       inclusive=inclusive)
    res = compile_plan(plan)(values)
    if cost is not None:
        cost.absorb(res.stats)
    return res.values


def prefix_sum_opt(values: torch.Tensor, inclusive: bool = True
                   ) -> torch.Tensor:
    """Optimized counterpart: one ``torch.cumsum`` in the input's dtype."""
    values = torch.as_tensor(values)
    c = torch.cumsum(values, dim=0, dtype=values.dtype)
    return c if inclusive else c - values


def prefix_cost_bound(n: int, M: int) -> Tuple[int, int]:
    """The paper's bound as concrete ceilings the implementation respects:
    rounds <= 2L + 1, communication <= (2L + 1) * 2N (Lemma 2.2)."""
    d = max(2, M // 2)
    L = tree_height(max(n, 2), d)
    return 2 * L + 1, (2 * L + 1) * 2 * n


def _draw_slots(key, n: int, universe: int, device) -> torch.Tensor:
    """The (n,) int32 slots in [0, universe) a random-indexing key stands
    for: drawn uniformly from an int seed or a ``torch.Generator``, or the
    given integer slots themselves (how the tests hand over the JAX
    package's ``jax.random.randint`` draw)."""
    if isinstance(key, torch.Generator):
        return torch.randint(0, universe, (n,), generator=key,
                             device=key.device, dtype=torch.int32).to(device)
    if isinstance(key, (int, np.integer)):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(key))
        return torch.randint(0, universe, (n,), generator=gen, device=device,
                             dtype=torch.int32)
    slots = torch.as_tensor(np.array(key) if not isinstance(
        key, torch.Tensor) else key)
    if slots.shape != (n,) or slots.dtype.is_floating_point \
            or slots.dtype == torch.bool:
        raise ValueError(f"random-indexing slots must be a ({n},) integer "
                         f"array, got {slots.dtype} of shape "
                         f"{tuple(slots.shape)}")
    return slots.to(device=device, dtype=torch.int32)


def random_indexing(n: int, key, M: int, n_hat: Optional[int] = None,
                    cost: Optional[MRCost] = None,
                    device="cuda") -> torch.Tensor:
    """Lemma 2.3: assign the n input items dense unique indices 0..n-1 w.h.p.

    Each item picks a uniform slot in [0, N_hat^3) (clamped to int32, as in
    the JAX package); per-leaf counts are prefix-summed over the implicit
    tree of N_hat^3 leaves, turning slots into dense ranks; ties within a
    leaf are ordered arbitrarily.  The dense equivalent is a stable sort by
    slot.  ``key`` is read by :func:`_draw_slots`.  Runs on the card unless
    ``device`` says otherwise.

    Returns ``idx`` with idx[i] = dense index of item i (a permutation).
    """
    n_hat = int(n_hat if n_hat is not None else max(n, 2))
    universe = min(n_hat ** 3, 2**31 - 1)
    slots = _draw_slots(key, n, universe,
                        as_device(device, "random_indexing"))
    order = torch.argsort(slots, stable=True)     # the tree ranks the slots
    idx = torch.zeros((n,), dtype=torch.int32, device=slots.device)
    idx[order] = torch.arange(n, dtype=torch.int32, device=slots.device)
    if cost is not None:
        d = max(2, M // 2)
        L = max(1, math.ceil(3 * math.log(max(n_hat, 2)) / math.log(d)))
        occupancy = max_leaf_occupancy(slots)
        accum = CostAccum.zero(slots.device)
        accum = accum.add_round(items_sent=n, max_io=occupancy)  # into leaves
        for _ in range(2 * L):                           # tree up + down
            accum = accum.add_round(
                items_sent=n, max_io=torch.clamp_min(occupancy, d))
        cost.absorb(accum)
    return idx


def max_leaf_occupancy(slots: torch.Tensor) -> torch.Tensor:
    """Max leaf occupancy n_v — the paper's w.h.p. O(M) bound (Lemma 2.3):
    P[n_v > M] <= N^{-Omega(M)}.  The longest run of equal sorted slots, as
    an int32 0-d tensor."""
    slots = torch.as_tensor(slots)
    if slots.numel() == 0:
        return torch.ones((), dtype=torch.int32, device=slots.device)
    _, counts = torch.unique_consecutive(torch.sort(slots).values,
                                         return_counts=True)
    return counts.max().to(torch.int32)

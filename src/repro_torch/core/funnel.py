"""Invisible funnels and the CRCW PRAM simulation (paper §3.2, Theorem 3.2).

The paper simulates an f-CRCW PRAM (concurrent writes combined by a
commutative semigroup f) by hanging an implicit d-ary tree over the P
processors at every one of the N memory cells.  Reads funnel up (duplicate
requests collapse) and the value fans back down; writes funnel up combining
with f.  The trees are invisible: only non-empty tree nodes communicate, so
no O(NP) structure is materialized.

The sparse per-level representation is exact: an item at funnel level l is
keyed by (cell, group) with group = floor(leaf / d^l); combining the items
that share a key is one MR round.  The dense write combines each sorted
segment with a flag-segmented inclusive scan (Hillis-Steele doubling), so any
associative ``op`` works (sum, min, max, logaddexp, ...).  Its tree order
differs from a sequential fold: exact semigroups agree with the JAX
package's bit for bit, a float sum within rounding.  The engine plan folds
each mailbox row slot by slot in FIFO order, as the JAX package does, so it
is bit-identical for every semigroup.

Semigroups and PRAM programs are torch functions of torch tensors
(``torch.add``, ``torch.maximum``, ...).  :func:`scatter_combine_opt` is the
one-call counterpart.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .costmodel import CostAccum, MRCost, tree_height
from .mrmodel import scatter_or_drop
from .plan import (Plan, PlanState, custom_stage, dtype_name, execute_plan,
                   run_plan)

Semigroup = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _static_scalar(x):
    """Hashable fingerprint token for a semigroup identity (None or a
    number, or a 0-d tensor)."""
    if x is None:
        return None
    return float(x)


def _combine_sorted_segments(new_seg: torch.Tensor, values: torch.Tensor,
                             op: Semigroup) -> torch.Tensor:
    """Inclusive flag-segmented scan: position i holds the op-combination
    of all values since the last segment start, so the last position of each
    segment holds the fully combined value.  Hillis-Steele doubling over
    the pairs (flag, value) with the segmented operator
    (fa, va) . (fb, vb) = (fa | fb, vb if fb else op(va, vb))."""
    flag, val = new_seg, values
    step = 1
    while step < val.shape[0]:
        f_left, v_left = flag[:-step], val[:-step]
        f_right, v_right = flag[step:], val[step:]
        val = torch.cat([val[:step], torch.where(f_right, v_right,
                                                 op(v_left, v_right))])
        flag = torch.cat([flag[:step], f_left | f_right])
        step *= 2
    return val


class FunnelResult(NamedTuple):
    memory: torch.Tensor
    max_fan_in: torch.Tensor  # max items any tree node combined in one round
    stats: CostAccum          # functional per-round accounting


def _combine_mailbox_slots(payload: torch.Tensor, valid: torch.Tensor,
                           op: Semigroup):
    """Fold the slots of every mailbox row with ``op`` in FIFO (slot) order.

    ``payload`` and ``valid`` are (..., V, cap): a batch's leading axis
    folds in the same loop.  Returns (combined (..., V), any_valid (...,
    V)).  Rows with no valid slot keep slot 0's (garbage) value, masked by
    ``any_valid``.  The unrolled loop runs over the mailbox capacity — at
    most d = M/2 slots for funnel nodes — a few launches a slot, so that
    the fold order holds for any user ``op``; it runs once for a whole
    batch."""
    acc = payload[..., 0]
    has = valid[..., 0]
    for s in range(1, payload.shape[-1]):
        cur, ok = payload[..., s], valid[..., s]
        acc = torch.where(ok & has, op(acc, cur), torch.where(ok, cur, acc))
        has = has | ok
    return acc, has


def funnel_write_plan(n_procs: int, n_cells: int, M: int, op: Semigroup, *,
                      identity=None, dtype=torch.float32,
                      shape: bool = True) -> Plan:
    """Theorem 3.2 write funnel as a plan builder: every tree level is one
    named engine round.

    Level l routes the item of (cell c, group g) to node ``(g // d) * N +
    c``, so items sharing a parent funnel node meet in one mailbox
    (capacity d, never overflowed) and are combined slot-FIFO, which equals
    the dense path's leaf-order combine.  After L levels one item per live
    cell remains, indexed by cell; the root stage applies it to ``memory``.
    Inputs at execute time: ``(addrs, values, memory)``.  ``identity`` must
    be None or a concrete scalar (it is part of the fingerprint).

    ``shape=True`` (default) shape-schedules the funnel: level l's mailbox
    holds its live ceil(P/d^(l+1)) * N tree nodes, so the footprint shrinks
    by d per level as the invisible funnel's live node set does.
    ``shape=False`` keeps every level at the level-0 footprint — same
    dests, same capacities, bit-identical outputs and stats.
    """
    P, N, M = int(n_procs), int(n_cells), int(M)
    d = max(2, M // 2)
    L = tree_height(max(P, 2), d)
    fingerprint = ("funnel-write", P, N, M, op, _static_scalar(identity),
                   dtype_name(dtype), bool(shape))
    n_groups_seq = []                    # groups alive after each level
    g = P
    for _ in range(L):
        g = max(1, -(-g // d))
        n_groups_seq.append(g)

    def prologue(inputs, keys, device):
        addrs, values, memory = (torch.as_tensor(x, device=device)
                                 for x in inputs)
        live = addrs >= 0
        return {"vals": values, "live": live,
                "cells": torch.where(live, addrs, 0).to(torch.int32),
                "memory": memory,
                "max_fan": torch.ones((len(keys),), dtype=torch.int32,
                                      device=device)}

    stages = []
    for level, n_groups in enumerate(n_groups_seq):
        # The level's physical footprint: its live n_groups * N tree nodes
        # (shape-scheduled), or the frozen level-0 footprint.
        v_level = (n_groups if shape else n_groups_seq[0]) * N

        def make_apply(level=level, n_groups=n_groups, v_level=v_level):
            def apply(engine, state: PlanState) -> PlanState:
                c = state.carry
                dev = c["vals"].device
                idx = torch.arange(c["vals"].shape[-1], dtype=torch.int32,
                                   device=dev)
                # Leaf items carry their group explicitly; from the second
                # level on an item's position is (group * N + cell).
                group = idx if level == 0 else idx // N
                parent = group // d
                dests = torch.where(c["live"], parent * N + c["cells"], -1)
                V = engine.aligned_nodes(v_level)
                box, st = engine.shuffle_batch(dests, c["vals"], V, d)
                accum = state.accum.add_round_stats(st)
                comb, has = _combine_mailbox_slots(box.payload, box.valid, op)
                cells = torch.arange(n_groups * N, dtype=torch.int32,
                                     device=comb.device) % N
                carry = {
                    "vals": comb[:, :n_groups * N],
                    "live": has[:, :n_groups * N],
                    "cells": cells.expand(comb.shape[0], -1),
                    "memory": c["memory"],
                    "max_fan": torch.maximum(
                        c["max_fan"],
                        torch.as_tensor(st.max_received,
                                        device=dev).to(torch.int32)),
                }
                return PlanState(state.box, carry, accum)
            return apply
        stages.append(custom_stage(f"funnel-level-{level}", 1, d,
                                   make_apply(), v_level))

    def root_apply(engine, state: PlanState) -> PlanState:
        # One item per cell remains, at position cell (n_groups == 1).
        c = state.carry
        vals, live, memory = c["vals"], c["live"], c["memory"]
        if identity is None:
            merged = op(memory, vals)
            memory = torch.where(live, merged, memory)
        else:
            memory = op(memory, torch.where(
                live, vals, torch.as_tensor(identity, dtype=vals.dtype,
                                            device=vals.device)))
        accum = state.accum.add_round(items_sent=live.sum(-1), max_io=1)
        return PlanState(state.box, {**c, "memory": memory}, accum)

    stages.append(custom_stage("root", 1, 1, root_apply))

    def epilogue(state):
        return FunnelResult(memory=state.carry["memory"],
                            max_fan_in=state.carry["max_fan"],
                            stats=state.accum)

    return Plan(name="funnel-write", fingerprint=fingerprint, n_nodes=P * N,
                stages=tuple(stages), prologue=prologue, epilogue=epilogue,
                round_bound=L + 1,
                input_spec=(((P,), None), ((P,), None), ((N,), None)))


def _funnel_write_engine(addrs, values, memory, op, M, engine, identity,
                         shape: bool = True, batched: bool = False):
    """Engine-path funnel write: build the plan and interpret it directly
    (no compile cache).  ``batched``: the inputs are B stacked queries'
    (B, P), (B, P) and (B, N) tensors, run as one batch of the plan."""
    plan = funnel_write_plan(addrs.shape[-1], memory.shape[-1], M, op,
                             identity=identity,
                             dtype=getattr(values, "dtype", torch.float32),
                             shape=shape)
    if batched:
        return run_plan(plan, engine, (addrs, values, memory),
                        [{}] * addrs.shape[0])
    return execute_plan(plan, engine, (addrs, values, memory))


def funnel_write(addrs: torch.Tensor, values: torch.Tensor,
                 memory: torch.Tensor, op: Semigroup, M: int,
                 cost: Optional[MRCost] = None,
                 identity=None, engine=None) -> FunnelResult:
    """Bottom-up write phase of Theorem 3.2.

    Processor i writes ``values[i]`` to cell ``addrs[i]`` (addr < 0 = no
    write); concurrent writes to a cell are combined with the commutative
    semigroup ``op`` through the cell's implicit d-ary funnel, then the root
    applies the combined update to ``memory`` (again with ``op``).

    Accounting is functional (``result.stats`` is a :class:`CostAccum`);
    the mutable ``cost`` adapter, if given, absorbs it once at the end.

    With ``engine=`` the funnel levels run as rounds of that engine (same
    tree, same combine order); that path is a deprecated wrapper over
    :func:`funnel_write_plan`.  ``engine=None`` keeps the dense
    segmented-scan realization, on the inputs' device.
    """
    if engine is not None:
        from .api import deprecated_entry
        deprecated_entry("funnel_write(engine=...)", "funnel_write_plan")
        res = _funnel_write_engine(addrs, values, memory, op, M, engine,
                                   identity)
    else:
        res = _funnel_write_dense(addrs, values, memory, op, M, identity)
    if cost is not None:
        cost.absorb(res.stats)                    # one host sync, at the end
    return res


def _lex_order(primary: torch.Tensor, secondary: torch.Tensor,
               n_secondary: int) -> torch.Tensor:
    """Stable order by (primary, secondary) — ``jnp.lexsort((secondary,
    primary))`` — for primary >= -1 and secondary in [0, n_secondary)."""
    key = (primary.long() + 1) * n_secondary + secondary.long()
    return torch.argsort(key, dim=-1, stable=True)


def _funnel_write_dense(addrs, values, memory, op, M, identity):
    """Dense segmented-scan realization of the Theorem 3.2 write funnel."""
    addrs, values = torch.as_tensor(addrs), torch.as_tensor(values)
    memory = torch.as_tensor(memory)
    dev = addrs.device
    P = addrs.shape[0]
    d = max(2, M // 2)
    L = tree_height(max(P, 2), d)

    live = addrs >= 0
    cells = torch.where(live, addrs, -1).to(torch.int32)
    group = torch.arange(P, dtype=torch.int32, device=dev)  # leaf of proc i
    vals = values
    max_fan = torch.ones((), dtype=torch.int32, device=dev)
    accum = CostAccum.zero(dev)
    first = torch.ones((1,), dtype=torch.bool, device=dev)
    pos = torch.arange(P, device=dev)
    for _ in range(L):                        # L rounds up the funnel
        group = group // d
        # Items sharing (cell, group) meet at one tree node: sort, combine.
        order = _lex_order(cells, group, P)
        cells_s, group_s, vals_s = cells[order], group[order], vals[order]
        live_s = live[order]
        new_seg = torch.cat([first, (cells_s[1:] != cells_s[:-1])
                             | (group_s[1:] != group_s[:-1])])
        scanned = _combine_sorted_segments(new_seg, vals_s, op)
        is_last = torch.cat([new_seg[1:], first])
        seg_ord = torch.cumsum(new_seg, 0) - 1      # ordinal of each segment
        # Fan-in accounting: size of the largest live segment this round.
        sizes = torch.zeros((P,), dtype=torch.int32, device=dev).index_add_(
            0, seg_ord, live_s.to(torch.int32))
        round_fan = sizes.max()
        max_fan = torch.maximum(max_fan, round_fan)
        # Compact: one item per segment survives, at its ordinal position.
        def compact(fill, x):
            return scatter_or_drop(torch.full((P,), fill, dtype=x.dtype,
                                              device=dev),
                                   seg_ord, is_last, x, pos)

        cells = compact(-1, cells_s)
        group = compact(0, group_s)
        vals = compact(0, scanned)
        live = compact(False, live_s)
        accum = accum.add_round(items_sent=live.sum(),
                                max_io=round_fan.clamp_min(1).clamp_max(M))

    # Root round: each cell now has at most one live combined item.
    n_cells = memory.shape[0]
    upd_addr = torch.where(live, cells, n_cells).long()
    if identity is None:
        current = memory[cells.clamp(0, n_cells - 1).long()]
        merged = op(current, vals)
        base = torch.cat([memory, memory[:1]])
        base[upd_addr] = torch.where(live, merged, current)
        memory = base[:n_cells]
    else:
        base = torch.full((n_cells + 1,), float(identity), dtype=memory.dtype,
                          device=dev)
        base[upd_addr] = torch.where(live, vals, torch.as_tensor(
            identity, dtype=vals.dtype, device=dev)).to(memory.dtype)
        memory = op(memory, base[:n_cells])
    accum = accum.add_round(items_sent=live.sum(), max_io=1)
    return FunnelResult(memory=memory, max_fan_in=max_fan, stats=accum)


def funnel_read_accum(addrs: torch.Tensor, memory: torch.Tensor, M: int
                      ) -> Tuple[torch.Tensor, CostAccum]:
    """Read phase of Theorem 3.2, with functional accounting.

    Bottom-up: duplicate requests for the same cell collapse at each funnel
    level (so a cell read by all P processors costs O(log_M P) rounds, not
    O(P) fan-in).  Top-down: the value retraces the funnel to every
    requester.  The result equals ``memory[addrs]``; rounds and
    communication are accounted per the sparse funnel.  ``addrs`` (..., P)
    and ``memory`` (..., N) may carry a batch's leading axis, and the
    accumulator then has it too.
    """
    addrs, memory = torch.as_tensor(addrs), torch.as_tensor(memory)
    dev = addrs.device
    lead, P = tuple(addrs.shape[:-1]), addrs.shape[-1]
    d = max(2, M // 2)
    L = tree_height(max(P, 2), d)
    accum = CostAccum.zero(dev, lead)
    group = torch.arange(P, dtype=torch.int32, device=dev).expand(addrs.shape)
    live = torch.full(lead, P, dtype=torch.int32, device=dev)
    first = torch.ones(lead + (1,), dtype=torch.bool, device=dev)
    fan_out_per_level = []
    for _ in range(L):
        group = group // d
        order = _lex_order(addrs, group, P)
        a_s, g_s = addrs.gather(-1, order), group.gather(-1, order)
        uniq = torch.cat([first, (a_s[..., 1:] != a_s[..., :-1])
                          | (g_s[..., 1:] != g_s[..., :-1])],
                         dim=-1).sum(-1).to(torch.int32)
        accum = accum.add_round(items_sent=live, max_io=min(d, M))
        fan_out_per_level.append(live)                      # requests up
        live = uniq
    for width in reversed(fan_out_per_level):               # values down
        accum = accum.add_round(items_sent=width, max_io=min(d, M))
    accum = accum.add_round(items_sent=P, max_io=1)         # leaves -> procs
    return memory.gather(-1, addrs.long()), accum


def funnel_read(addrs: torch.Tensor, memory: torch.Tensor, M: int,
                cost: Optional[MRCost] = None) -> torch.Tensor:
    """Host-adapter form of :func:`funnel_read_accum` (skips the accounting
    entirely when no ``cost`` is attached)."""
    if cost is not None:
        vals, accum = funnel_read_accum(addrs, memory, M)
        cost.absorb(accum)                                  # one host sync
        return vals
    return torch.as_tensor(memory)[torch.as_tensor(addrs).long()]


def scatter_combine_opt(addrs: torch.Tensor, values: torch.Tensor,
                        memory: torch.Tensor, op_name: str) -> torch.Tensor:
    """Optimized funnel write: one library scatter-reduce (``index_add_``
    or ``scatter_reduce_``); addr < 0 writes nothing."""
    addrs, values = torch.as_tensor(addrs), torch.as_tensor(values)
    memory = torch.as_tensor(memory)
    n_cells = memory.shape[0]
    a = torch.where(addrs >= 0, addrs, n_cells).long()
    out = torch.cat([memory, memory[:1]])          # one spill slot
    if op_name == "sum":
        out.index_add_(0, a, values.to(memory.dtype))
    elif op_name in ("max", "min"):
        out.scatter_reduce_(0, a, values.to(memory.dtype),
                            reduce="a" + op_name, include_self=True)
    else:
        raise ValueError(f"unsupported semigroup {op_name!r}")
    return out[:n_cells]


def _crcw_step(prog, proc_state, memory, t, M, op, identity, engine,
               need_accum, accum, shape: bool = True, batched: bool = False):
    """One PRAM step of the Theorem 3.2 simulation: funnel read, compute,
    funnel write.  ``shape`` selects the engine write funnel's
    shape-scheduled or frozen footprint (bit-identical results and
    stats).  ``batched``: state, memory and ``accum`` carry a batch's
    leading axis, and the engine write funnel runs as one batch."""
    addrs = prog.read_addr(proc_state, t)
    if need_accum:
        vals, racc = funnel_read_accum(addrs, memory, M)
        accum = accum.merge_sequential(racc)
    else:
        vals = memory.gather(-1, addrs.long())
    proc_state, w_addr, w_val = prog.compute(proc_state, vals, t)
    if engine is not None:
        res = _funnel_write_engine(w_addr, w_val, memory, op, M, engine,
                                   identity, shape=shape, batched=batched)
    else:
        res = _funnel_write_dense(w_addr, w_val, memory, op, M, identity)
    return proc_state, res.memory, accum.merge_sequential(res.stats)


class PRAMProgram(NamedTuple):
    """One step of an f-CRCW PRAM program (paper §3.2 read/compute/write).

    read_addr(state, t)               -> (P,) cell per processor (>=0)
    compute(state, read_vals, t)      -> (new_state, write_addr (P,), write_val (P,))
                                          write_addr < 0 suppresses the write.
    """
    read_addr: Callable
    compute: Callable


def simulate_crcw(prog: PRAMProgram, proc_state, memory: torch.Tensor,
                  n_steps: int, M: int, op: Semigroup,
                  cost: Optional[MRCost] = None,
                  identity=None, engine=None, with_accum: bool = False):
    """Theorem 3.2 driver: T PRAM steps -> O(T log_M P) MR rounds.

    Returns (final_proc_state, final_memory), or with ``with_accum=True``
    (final_proc_state, final_memory, CostAccum).  With ``engine=`` the
    write funnels run as rounds of that engine (see :func:`funnel_write`);
    read accounting is the engine-independent sparse-funnel formula either
    way.  Without an engine everything runs on ``memory``'s device."""
    memory = torch.as_tensor(memory)
    # Read accounting costs L sorts over P per step — only compute it when
    # someone will consume it (funnel_read's adapter does the same).
    need_accum = with_accum or cost is not None
    accum = CostAccum.zero(memory.device)
    for t in range(n_steps):
        proc_state, memory, accum = _crcw_step(
            prog, proc_state, memory, t, M, op, identity, engine,
            need_accum, accum)
    if cost is not None:
        cost.absorb(accum)                                  # one host sync
    if with_accum:
        return proc_state, memory, accum
    return proc_state, memory

"""BSP simulation (paper §3.1, Theorem 3.1).

A BSP algorithm with P <= N processors, memory N and R supersteps maps
directly onto the generic model: processor p_i = node v_i; its internal
state pi_i and memory cells m_{i,*} are the node's items; one superstep =
one MR round; message routing = the Shuffle.  M = ceil(N/P) bounds the
per-processor message volume, matching the reducer I/O bound.

A superstep is written in torch: it takes and returns tensors on the
engine's device.  It is written for one query, with the shapes below; a
batch of B queries runs it under ``torch.func.vmap`` over the batch axis,
with PyTorch's per-row fallback turned off, so an operation without a
batching rule raises instead of looping over the rows.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from .._tree import tree_flatten, tree_leaves, tree_map
from .costmodel import CostAccum, MRCost
from .mrmodel import Mailbox
from .plan import (Plan, PlanState, batch_of_one, custom_stage, dtype_name,
                   row_of)


class BSPProgram(NamedTuple):
    """superstep(t, proc_ids, proc_state, inbox, inbox_valid) ->
         (new_proc_state, out_dests (P, M), out_msgs nest (P, M, ...))

    ``out_dests`` entries < 0 mean "no message".  ``proc_state`` is a nest
    with leading dim P and persists across supersteps (the paper's pi_i and
    memory cells m_{i,j}, which the node keeps by sending to itself)."""
    superstep: Callable


class BSPResult(NamedTuple):
    """Output of the BSP simulation plan.  ``dropped_per_step`` localizes
    the strict-model violation (message bound M exceeded) to its superstep
    without any host synchronization inside the round loop."""

    proc_state: Any
    dropped_per_step: torch.Tensor   # (R,) int32
    stats: CostAccum


def _structure_signature(structure):
    """A hashable token of a :func:`~repro_torch._tree.tree_flatten`
    structure (the port's counterpart of a JAX treedef)."""
    if structure is None or structure == "*":
        return structure
    kind, keys, children = structure
    return (kind.__qualname__, None if keys is None else tuple(keys),
            tuple(_structure_signature(c) for c in children))


def bsp_plan(prog: BSPProgram, n_supersteps: int, M: int, n_procs: int,
             msg_template: Any) -> Plan:
    """Theorem 3.1 as a plan builder: R supersteps -> R named one-round
    stages, C = O(R * N).

    The message exchange of superstep t is the engine's Shuffle step at
    capacity M; the superstep index is a Python int, so round functions may
    branch on it.  Input at execute time: ``(proc_state,)``.  A
    message-bound violation does not raise mid-flight: it is reported per
    superstep in ``dropped_per_step`` (the deprecated :func:`run_bsp`
    wrapper raises)."""
    n_supersteps, M, n_procs = int(n_supersteps), int(M), int(n_procs)
    leaves, structure = tree_flatten(msg_template)
    leaves = [torch.as_tensor(l) for l in leaves]
    fingerprint = ("bsp", prog.superstep, n_supersteps, M, n_procs,
                   _structure_signature(structure),
                   tuple((dtype_name(l.dtype), tuple(l.shape)) for l in leaves))

    def prologue(inputs, keys, device):
        B = len(keys)
        proc_state = tree_map(lambda x: torch.as_tensor(x, device=device),
                              inputs[0])
        inbox = Mailbox(
            payload=tree_map(
                lambda t: torch.zeros((B, n_procs, M) + tuple(t.shape),
                                      dtype=t.dtype, device=device),
                tree_map(torch.as_tensor, msg_template)),
            valid=torch.zeros((B, n_procs, M), dtype=torch.bool,
                              device=device),
        )
        # one query's state items (leaves are (B, ...))
        state_items = sum(int(x.shape[1]) if x.ndim > 1 else 1
                          for x in tree_leaves(proc_state))
        return {"proc_state": proc_state, "inbox": inbox,
                "state_items": state_items, "drops": ()}

    stages = []
    for t in range(n_supersteps):
        def make_apply(t=t):
            def apply(engine, state: PlanState) -> PlanState:
                c = state.carry
                proc_ids = engine.node_ids(n_procs)
                proc_state, dests, msgs = _superstep(
                    prog, t, proc_ids, c["proc_state"], c["inbox"].payload,
                    c["inbox"].valid)
                inbox, stats = engine.shuffle_batch(dests, msgs, n_procs, M)
                # kept state counts as send-to-self (the "keep" primitive)
                accum = state.accum.add_round(
                    items_sent=stats.items_sent + c["state_items"],
                    max_io=torch.maximum(stats.max_sent,
                                         stats.max_received),
                    dropped=stats.dropped)
                carry = {**c, "proc_state": proc_state, "inbox": inbox,
                         "drops": c["drops"] + (stats.dropped,)}
                return PlanState(state.box, carry, accum)
            return apply
        stages.append(custom_stage(f"superstep-{t}", 1, M, make_apply()))

    def epilogue(state):
        drops = state.carry["drops"]
        return BSPResult(
            proc_state=state.carry["proc_state"],
            dropped_per_step=(torch.stack([d.to(torch.int32) for d in drops],
                                          dim=-1)
                              if drops else
                              torch.zeros(state.accum.rounds.shape + (0,),
                                          dtype=torch.int32)),
            stats=state.accum)

    return Plan(name="bsp", fingerprint=fingerprint, n_nodes=n_procs,
                stages=tuple(stages), prologue=prologue, epilogue=epilogue,
                round_bound=n_supersteps)


def _superstep(prog: BSPProgram, t: int, proc_ids, proc_state, inbox,
               inbox_valid):
    """One superstep of a batch: on the one query of a batch of one, or
    under ``torch.func.vmap`` over the batch axis with the per-row
    fallback turned off."""
    if inbox_valid.shape[0] == 1:
        out = prog.superstep(t, proc_ids, *row_of((proc_state, inbox,
                                                   inbox_valid)))
        return batch_of_one(out)
    step = torch.func.vmap(lambda s, i, v: prog.superstep(t, proc_ids, s,
                                                          i, v))
    functorch = torch._C._functorch
    was = functorch._is_vmap_fallback_enabled()
    functorch._set_vmap_fallback_enabled(False)
    try:
        return step(proc_state, inbox, inbox_valid)
    finally:
        functorch._set_vmap_fallback_enabled(was)


def run_bsp(prog: BSPProgram, proc_state: Any, n_supersteps: int, M: int,
            n_procs: int, msg_template: Any,
            cost: Optional[MRCost] = None, engine=None) -> Any:
    """Deprecated wrapper over :func:`bsp_plan`: builds the plan, compiles
    it on ``engine`` (default: the shared LocalEngine on the card) and runs
    it, enforcing the strict model (raises at the first superstep that
    exceeded the message bound M) and feeding the mutable ``cost``
    adapter."""
    from .api import deprecated_entry
    deprecated_entry("run_bsp", "bsp_plan")
    if engine is None:
        from .engine import default_engine
        engine = default_engine()
    plan = bsp_plan(prog, n_supersteps, M, n_procs, msg_template)
    res = engine.compile(plan)(proc_state)
    drops = res.dropped_per_step.cpu()
    if bool(drops.any()):
        t = int(torch.nonzero(drops)[0, 0])
        # Strict-model validity per superstep: running on after a drop would
        # feed later supersteps a silently truncated inbox.
        raise RuntimeError(
            f"superstep {t}: processor exceeded message bound M={M} "
            f"({int(drops[t])} messages dropped)")
    if cost is not None:
        cost.absorb(res.stats)
    return res.proc_state

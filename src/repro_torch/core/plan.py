"""Declarative round-program plans: the plan half of the plan/compile/execute
split.

Once (N, M) are fixed, the round schedule of the paper's algorithms is
static; only the data varies.  A :class:`Plan` is an algorithm with the data
removed:

- **named stages** (:class:`PlanStage`), each declaring how many rounds it
  contributes and at what mailbox capacity, plus the callable that executes
  it against an :class:`~repro_torch.core.engine.MREngine`;
- a **prologue** that turns the runtime inputs (and random-sample sources)
  into the initial carry on the engine's device, and an **epilogue** that
  turns the final :class:`PlanState` into the algorithm's result;
- the **paper round-bound ceiling** (``round_bound``) and the declared
  **PRNG slots** the plan consumes.

``MREngine.compile(plan)`` binds a plan once per (fingerprint, backend) into
a cached :class:`~repro_torch.core.api.Executable`; :func:`execute_plan` is
the interpreter both share.

The round program is written batch first: the prologue receives the inputs
stacked on a leading axis of B queries and one key per query, and every
stage and the epilogue work on (B, ...) tensors — mailboxes (B, V, M), a
(B,) :class:`~repro_torch.core.costmodel.CostAccum` — so B queries run as
one program, each shuffle one shuffle for the batch
(:func:`execute_plan_batch`).  One query is a batch of one with the axis
dropped at the end (:func:`execute_plan`).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._tree import tree_map
from ..obs import NULL_TRACER, plan_token, round_event as _round_event
from .costmodel import CostAccum
from .engine import stats_row
from .mrmodel import Mailbox


class PlanStage(NamedTuple):
    """One named step of a plan's static schedule.

    ``rounds``, ``capacity`` and ``n_nodes`` are the *declared* schedule;
    ``apply`` is the executable body ``(engine, PlanState) -> PlanState``
    and must account exactly ``rounds`` rounds into the state's
    accumulator.  ``(n_nodes, capacity)`` is the stage's declared mailbox
    footprint ``(V_r, M_r)``; None inherits the current mailbox shape."""

    name: str
    rounds: int
    capacity: Optional[int]
    apply: Callable
    n_nodes: Optional[int] = None
    #: whether the stage physically shuffles (accounting-only and compute
    #: stages set False so footprint metrics skip them)
    shuffles: bool = True
    #: declared overlap legality: True promises the stage's destinations
    #: depend only on node ids and the static schedule, never on mailbox
    #: data, which lets ``ShardedEngine`` issue its rounds as one window
    #: with no host read between them.  Declared by the builder, never
    #: inferred; a scheduling hint only (results and ``CostAccum`` are the
    #: same either way), and left out of ``shape_fingerprint`` as the JAX
    #: package leaves it out.
    early_dests: bool = False


class PlanState(NamedTuple):
    """Threaded execution state: the current mailbox (None before the entry
    shuffle), an arbitrary nest ``carry`` and the cost accumulator."""

    box: Optional[Mailbox]
    carry: Any
    accum: CostAccum


class Plan(NamedTuple):
    """A round program with the data removed (see module docstring).

    ``fingerprint`` is a hashable tuple of every static parameter that went
    into the build; the engine plan cache keys on it."""

    name: str
    fingerprint: Tuple
    n_nodes: int
    stages: Tuple[PlanStage, ...]
    #: (inputs: tuple stacked on a leading batch axis, keys: one dict per
    #: query, device) -> carry, every tensor of it with the batch axis
    prologue: Callable
    epilogue: Callable            # (PlanState) -> outputs
    round_bound: int              # concrete ceiling realizing the paper's O(.)
    prng_slots: Tuple[str, ...] = ()
    default_seed: int = 7
    #: per-input (shape, dtype-or-None) pairs (None entry/spec = unchecked)
    input_spec: Optional[Tuple] = None

    @property
    def total_rounds(self) -> int:
        """Rounds the declared schedule executes (must be <= round_bound)."""
        return sum(s.rounds for s in self.stages)

    def schedule(self) -> Tuple[Tuple[str, int, Optional[int],
                                      Optional[int]], ...]:
        """The static shape schedule as (stage name, rounds, capacity,
        n_nodes) rows."""
        return tuple((s.name, s.rounds, s.capacity, s.n_nodes)
                     for s in self.stages)

    @property
    def shape_fingerprint(self) -> Tuple:
        """The declared shape schedule as a hashable token, part of the
        plan-cache key."""
        return tuple((s.rounds, s.capacity, s.n_nodes) for s in self.stages)

    def _resolved_footprints(self):
        v, m = self.n_nodes, None
        rows = []
        for s in self.stages:
            v = s.n_nodes if s.n_nodes is not None else v
            m = s.capacity if s.capacity is not None else m
            if s.shuffles and v is not None and m is not None:
                rows.append((s.rounds, int(v), int(m)))
        return rows

    def peak_mailbox_slots(self) -> int:
        """Max declared physical footprint V_r * M_r over the schedule."""
        return max((v * m for _, v, m in self._resolved_footprints()),
                   default=0)

    def total_mailbox_slots(self) -> int:
        """Sum over rounds of the declared footprint V_r * M_r."""
        return sum(max(r, 1) * v * m
                   for r, v, m in self._resolved_footprints())

    def describe(self) -> str:
        """Render the shape schedule, one row per stage.

        >>> p = Plan(name="demo", fingerprint=("demo",), n_nodes=8,
        ...          stages=(PlanStage("entry", 1, 4, None, 8),
        ...                  PlanStage("finalize", 1, None, None)),
        ...          prologue=None, epilogue=None, round_bound=2)
        >>> print(p.describe())
        Plan 'demo': V=8, rounds=2 (bound 2), prng=[]
          entry            rounds=1   capacity=4        n_nodes=8
          finalize         rounds=1   capacity=inherit  n_nodes=inherit
        """
        rows = [f"Plan {self.name!r}: V={self.n_nodes}, "
                f"rounds={self.total_rounds} (bound {self.round_bound}), "
                f"prng={list(self.prng_slots)}"]
        for name, rounds, cap, nodes in self.schedule():
            cap_s = "inherit" if cap is None else cap
            nodes_s = "inherit" if nodes is None else nodes
            rows.append(f"  {name:<16} rounds={rounds:<3} "
                        f"capacity={cap_s:<8} n_nodes={nodes_s}")
        return "\n".join(rows)

    def split_key(self, key) -> dict:
        """Resolve the caller's key into one source per declared PRNG slot.

        A source is an int seed, a ``torch.Generator`` or, for a sampling
        slot, the sample indices themselves.  A single slot receives the
        key unchanged; several slots take a dict keyed by slot name.
        ``key=None`` falls back to the seed ``default_seed``."""
        if not self.prng_slots:
            return {}
        if key is None:
            key = self.default_seed
        if isinstance(key, dict):
            missing = set(self.prng_slots) - set(key)
            if missing:
                raise ValueError(f"plan {self.name!r}: no key for slots "
                                 f"{sorted(missing)}")
            return dict(key)
        if len(self.prng_slots) == 1:
            return {self.prng_slots[0]: key}
        raise ValueError(f"plan {self.name!r} has slots {self.prng_slots}: "
                         f"pass a dict with one key per slot")


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype, or the torch dtype of a numpy dtype (or its name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def dtype_name(dtype) -> str:
    """A dtype's name as numpy spells it (``'float32'``, ``'bfloat16'``):
    the token plan fingerprints carry, equal to the JAX package's
    ``str(dtype)``, so :func:`~repro_torch.obs.plan_token` and
    :func:`~repro_torch.core.recovery.plan_digest` equal JAX's."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def dtype_max(dtype: torch.dtype):
    """The largest value of a torch dtype (the sort and search padding)."""
    if dtype.is_floating_point:
        return torch.finfo(dtype).max
    return torch.iinfo(dtype).max


def _check_inputs(plan: Plan, inputs: Tuple) -> None:
    """Fail loudly when runtime inputs disagree with the plan's baked-in
    statics (shapes/dtypes are part of the fingerprint, not of the data)."""
    if plan.input_spec is None:
        return
    if len(inputs) != len(plan.input_spec):
        raise ValueError(
            f"plan {plan.name!r} expects {len(plan.input_spec)} inputs, "
            f"got {len(inputs)}")
    for i, (spec, x) in enumerate(zip(plan.input_spec, inputs)):
        if spec is None:
            continue
        shape, dtype = spec
        got = tuple(np.shape(x)) if not isinstance(x, torch.Tensor) \
            else tuple(x.shape)
        if got != tuple(shape):
            raise ValueError(
                f"plan {plan.name!r} input {i}: expected shape "
                f"{tuple(shape)} (baked into the plan), got {got} — rebuild "
                f"the plan for this size")
        got_dtype = getattr(x, "dtype", None)
        if dtype is not None and got_dtype is not None \
                and torch_dtype(got_dtype) != dtype:
            raise ValueError(
                f"plan {plan.name!r} input {i}: expected dtype {dtype} "
                f"(baked into the plan), got {torch_dtype(got_dtype)} — "
                f"rebuild the plan for this dtype")


def batch_of_one(tree):
    """``tree`` with a leading batch axis of one on every tensor and numpy
    array leaf; other leaves (a carry's Python numbers) pass unchanged."""
    return tree_map(lambda x: x[None] if isinstance(x, (torch.Tensor,
                                                        np.ndarray)) else x,
                    tree)


def row_of(tree, b: int = 0):
    """Query ``b`` of a batched tree: every tensor leaf indexed at ``b`` on
    its leading axis; other leaves pass unchanged."""
    return tree_map(lambda x: x[b] if isinstance(x, torch.Tensor) else x,
                    tree)


def initial_state(plan: Plan, inputs: Tuple, keys, device) -> PlanState:
    """The state before the first stage: the prologue's carry of B stacked
    queries (one key dict per query in ``keys``) and a (B,) accumulator."""
    carry = plan.prologue(tuple(inputs), list(keys), device)
    return PlanState(box=None, carry=carry,
                     accum=CostAccum.zero(device, (len(keys),)))


def run_plan(plan: Plan, engine, inputs: Tuple, keys,
             checkpointer=None):
    """The interpreter: B queries, stacked in ``inputs``, with one key dict
    each in ``keys``, through the plan's stages as one round program;
    returns the outputs with their batch axis.  Per-stage spans record
    when the engine's tracer is live and not a batch's
    :class:`~repro_torch.obs.BatchTracer`.  Plans that run another plan
    inside a stage call this on their own batch."""
    state = initial_state(plan, inputs, keys, engine.device)
    if checkpointer is not None:
        from .recovery import _apply_stages
        state = _apply_stages(plan, engine, state, 0, checkpointer)
    else:
        tr = getattr(engine, "tracer", NULL_TRACER)
        if tr.enabled and not getattr(tr, "batch", False):
            state = _traced_stages(plan, engine, state, tr)
        else:
            for stage in plan.stages:
                state = stage.apply(engine, state)
    return plan.epilogue(state)


def execute_plan_batch(plan: Plan, engine, inputs: Tuple, keys):
    """Run B queries of a plan as one round program: ``inputs`` stacked on
    a leading axis of size B, ``keys`` a length-B sequence of the keys
    :meth:`Plan.split_key` reads.  Every output leaf has a leading axis of
    size B, row b bit for bit what ``execute_plan`` gives for query b."""
    keys = list(keys)
    _check_inputs(plan, tree_map(lambda x: x[0], tuple(inputs)))
    return run_plan(plan, engine, inputs,
                    [plan.split_key(k) for k in keys])


def execute_plan(plan: Plan, engine, inputs: Tuple, key=None,
                 checkpointer=None):
    """Run a plan's stages in order on ``engine`` and return its outputs.

    The query runs as a batch of one (:func:`run_plan`), its outputs
    without the batch axis.  The prologue receives the engine's device and
    moves the inputs there.

    ``checkpointer`` (a :class:`repro_torch.core.recovery.Checkpointer`)
    turns on the ``checkpoint_every`` policy: after each stage the full
    ``{"box", "carry", "accum"}`` state is offered to ``maybe_save`` at
    that stage's cumulative round index, producing the round-boundary
    snapshots :func:`~repro_torch.core.recovery.run_plan_with_recovery` and
    :func:`~repro_torch.core.recovery.resume_plan` replay from.

    With a recording tracer on the engine, each stage runs under a
    ``plan.stage`` span inside one ``plan.execute`` span (reading the
    measured deltas is a host sync: the opt-in cost of tracing).  The
    default ``NULL_TRACER`` takes the plain loop, with no sync."""
    _check_inputs(plan, inputs)
    return row_of(run_plan(plan, engine, batch_of_one(tuple(inputs)),
                           [plan.split_key(key)], checkpointer))


def _traced_apply(plan: Plan, engine, i: int, state: PlanState,
                 tr) -> PlanState:
    """Stage ``i`` under a ``plan.stage`` span that records its declared
    schedule beside the measured ``CostAccum`` deltas (rounds, items sent,
    drops), so :func:`repro_torch.obs.summarize` can check measured ==
    declared.  A stage killed mid-apply by an injected fault records its
    span with ``aborted=True``."""
    stage = plan.stages[i]
    r0 = int(state.accum.rounds)
    c0 = float(state.accum.communication)
    d0 = int(state.accum.dropped)
    with tr.span("plan.stage", plan=plan.name, stage=stage.name,
                 rounds=stage.rounds, capacity=stage.capacity,
                 n_nodes=stage.n_nodes, shuffles=stage.shuffles) as sp:
        state = stage.apply(engine, state)
        sp["measured_rounds"] = int(state.accum.rounds) - r0
        sp["items_sent"] = int(float(state.accum.communication) - c0)
        sp["dropped"] = int(state.accum.dropped) - d0
    return state


def _traced_stages(plan: Plan, engine, state: PlanState, tr) -> PlanState:
    """The observable stage loop of :func:`execute_plan`: one
    ``plan.execute`` span wrapping one ``plan.stage`` span per stage."""
    with tr.span("plan.execute", plan=plan.name, digest=plan_token(plan),
                 backend=getattr(engine, "name", "?")):
        for i in range(len(plan.stages)):
            state = _traced_apply(plan, engine, i, state, tr)
    return state


# ---------------------------------------------------------------------------
# Stage constructors — the vocabulary the plan builders compose.
# ---------------------------------------------------------------------------

def account_stage(name: str,
                  round_costs: Tuple[Tuple[int, int], ...]) -> PlanStage:
    """Accounting-only rounds with static (items_sent, max_io) per round —
    e.g. the §4.3 pivot-sort rounds, whose cost depends only on (n, M)."""
    costs = tuple((int(i), int(io)) for i, io in round_costs)

    def apply(engine, state: PlanState) -> PlanState:
        acc = state.accum
        for items, io in costs:
            acc = acc.add_round(items_sent=items, max_io=io)
        return state._replace(accum=acc)

    return PlanStage(name, len(costs), None, apply, shuffles=False)


def entry_stage(name: str, n_nodes: int, capacity: int,
                emit: Callable) -> PlanStage:
    """The entry shuffle: ``emit(carry) -> (dests, payload)``, both (B,
    ...), routes the input collection into a fresh (B, n_nodes, capacity)
    mailbox."""

    def apply(engine, state: PlanState) -> PlanState:
        tr = getattr(engine, "tracer", NULL_TRACER)
        t0 = tr.clock() if tr.enabled else 0.0
        V = engine.aligned_nodes(n_nodes)
        dests, payload = emit(state.carry)
        box, st = engine.shuffle_batch(dests, payload, V, capacity)
        if tr.enabled:
            _round_event(tr, t0, getattr(engine, "name", "?"), 0,
                         V, capacity, stats_row(st))
        return PlanState(box, state.carry, state.accum.add_round_stats(st))

    return PlanStage(name, 1, capacity, apply, n_nodes)


def round_stage(name: str, make_fn: Callable, n_rounds: int,
                capacity: Optional[int] = None,
                n_nodes: Optional[int] = None,
                early_dests: bool = False) -> PlanStage:
    """``n_rounds`` applications of one round function over the current
    mailbox.  ``make_fn(carry) -> RoundFn`` binds the carry at execute time;
    the round function sees the (B, V, M) mailbox and the (V,) node ids and
    emits (B, V, M_out) destinations.  ``n_nodes`` declares the stage's
    target footprint V_r (a shape-change round when it differs from the
    current box); None inherits.  ``early_dests=True`` declares that the
    destinations depend only on node ids and the static schedule, which
    unlocks ``ShardedEngine``'s overlapped schedule for the stage."""

    def apply(engine, state: PlanState) -> PlanState:
        V = None if n_nodes is None else engine.aligned_nodes(n_nodes)
        box, accum = engine.run_rounds(make_fn(state.carry), state.box,
                                       n_rounds, capacity=capacity,
                                       accum=state.accum, n_nodes=V,
                                       early_dests=early_dests,
                                       batched=True)
        return state._replace(box=box, accum=accum)

    return PlanStage(name, n_rounds, capacity, apply, n_nodes,
                     early_dests=early_dests)


def compute_stage(name: str, fn: Callable) -> PlanStage:
    """A zero-round transform ``fn(box, carry) -> (box, carry)`` — local
    compute between shuffles (the paper's in-reducer work)."""

    def apply(engine, state: PlanState) -> PlanState:
        box, carry = fn(state.box, state.carry)
        return state._replace(box=box, carry=carry)

    return PlanStage(name, 0, None, apply, shuffles=False)


def custom_stage(name: str, rounds: int, capacity: Optional[int],
                 apply: Callable,
                 n_nodes: Optional[int] = None,
                 early_dests: bool = False) -> PlanStage:
    """Escape hatch for stages that drive the engine directly;
    ``apply(engine, state) -> state`` must account exactly ``rounds``
    rounds.  ``early_dests`` only declares overlap legality: a body that
    wants the overlapped schedule passes the flag to
    ``engine.run_rounds`` / ``run_stages`` itself."""
    return PlanStage(name, rounds, capacity, apply, n_nodes,
                     early_dests=early_dests)


__all__ = [
    "Plan", "PlanStage", "PlanState", "execute_plan", "execute_plan_batch",
    "run_plan", "batch_of_one", "row_of",
    "account_stage", "compute_stage", "custom_stage",
    "entry_stage", "round_stage",
]

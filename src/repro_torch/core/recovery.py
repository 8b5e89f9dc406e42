"""Fault-injected, checkpointed round execution with bit-identical recovery.

The port of the JAX package's ``repro.core.recovery``.  The round-based
model of Theorem 2.1 makes the unit of recovery explicit: the **round
boundary**.  Between rounds the entire computation state is one mailbox, a
plan carry and a functional cost accumulator, so a checkpoint taken at a
round boundary is a complete, replayable snapshot:

- :class:`FaultConfig` / :class:`FaultInjector` — seeded per-(attempt,
  shard) failure and straggler injection.  Draws come from
  ``np.random.default_rng([seed, attempt, shard])``, the JAX package's own
  draws, so the same config fires at the same shuffle attempts in both.
- :class:`FaultInjectingEngine` — a backend-agnostic proxy that puts the
  injector in front of any engine's Shuffle step.  It keeps the wrapped
  engine's device, so a query on the card stays on the card and its
  shuffles keep launching the kernels.
- :class:`Checkpointer` — round-boundary checkpoints of the
  ``{"box", "carry", "accum"}`` state keyed by ``(plan fingerprint, round
  index)``, on the step-atomic tmp-dir-then-rename protocol of
  :mod:`repro_torch.train.checkpoint`.
- :func:`run_plan_with_recovery` / :func:`resume_plan` — recovery by
  replaying from the last checkpoint.  Every engine's rounds are
  deterministic and bit-identical, so a recovered run produces
  **bit-identical outputs and cost accounting** to a fault-free run: the
  accumulator is restored from the checkpoint, so replayed rounds are never
  double-counted.

Typical use::

    from repro_torch.core import get_engine, sort_plan
    from repro_torch.core.recovery import (Checkpointer, FaultConfig,
                                           run_plan_with_recovery)

    engine = get_engine("kernel")                # on the card
    plan = sort_plan(4096, 64, align=engine.aligned_nodes)
    ck = Checkpointer("/tmp/ckpts", plan=plan, every=1)
    out, report = run_plan_with_recovery(
        plan, engine, (x,), faults=FaultConfig(fail_at=(1,)),
        checkpointer=ck)
    # out equals engine.compile(plan)(x) bit for bit; report says how many
    # rounds were replayed and how many checkpoints were written.

Where the port differs from the JAX package:

- The manifest carries a JSON ``structure`` record of the state's nest
  (dicts, lists, tuples, NamedTuples by module and name) and each tensor
  leaf's dtype (``tensor_dtypes``; bfloat16 is stored as float32, exactly)
  in place of the JAX package's pickled treedef.  The
  directory layout, the ``leaf_%05d`` files in the same leaf order and the
  ``leaf_kinds`` / ``stage_index`` / ``plan`` / ``rounds_done`` metadata
  are the JAX package's.  A checkpoint the JAX package wrote does not
  resume here.
- :func:`elastic_engine` takes a ``torch.distributed`` group where the JAX
  package takes a mesh axis, and every rank of the group must call it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import pathlib
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .._device import as_device
from .._tree import tree_flatten, tree_map, tree_unflatten
from ..obs import NULL_TRACER, Tracer, plan_token
from ..train import checkpoint as _ckpt
from .costmodel import CostAccum
from .engine import MREngine
from .mrmodel import Mailbox
from .plan import (Plan, PlanState, _check_inputs, _traced_apply,
                   batch_of_one, initial_state, row_of)


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------

class FaultError(RuntimeError):
    """Base class of injected execution faults."""


class ShardFailure(FaultError):
    """A shard died mid-round (the classic MapReduce worker failure).

    Raised by the injection layer *before* the shuffle executes, so a failed
    round leaves no partial state — the paper model's all-or-nothing round
    semantics.  ``round_index`` is the monotonic shuffle-attempt ordinal at
    which the failure fired (it never repeats across replays)."""

    def __init__(self, round_index: int, shard: int):
        super().__init__(
            f"injected shard failure: shard {shard} died at shuffle "
            f"attempt {round_index}")
        self.round_index = int(round_index)
        self.shard = int(shard)


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Knobs of the injection layer.

    ``failure_probability`` / ``straggler_probability`` are per-(attempt,
    shard) Bernoulli rates drawn from a generator seeded by ``(seed,
    attempt, shard)`` — deterministic and machine-independent.  ``fail_at``
    adds explicit failures: shuffle-attempt ordinals (0-based, counted
    across replays, so each fires exactly once).  ``max_failures`` caps
    total injected failures (None = unbounded); stragglers never fail a
    round — they only accrue simulated delay in the injector's event log
    (``straggler_delay_s`` virtual seconds each), so outputs and cost
    accounting stay bit-identical to a fault-free run."""

    failure_probability: float = 0.0
    straggler_probability: float = 0.0
    straggler_delay_s: float = 0.05
    seed: int = 0
    fail_at: Tuple[int, ...] = ()
    fail_shard: int = 0
    max_failures: Optional[int] = None


class FaultInjector:
    """Seeded fault source shared by one engine proxy across replays.

    ``calls`` is the monotonic shuffle-attempt counter.  Injected events are
    recorded as ``fault.failure`` / ``fault.straggler`` events into a
    private :class:`repro_torch.obs.Tracer` sink — and mirrored into the
    bound engine tracer when one is live — so traces and tests read one
    stream.  ``events`` is a read-only view of that sink (``(kind, attempt,
    shard)`` tuples)."""

    def __init__(self, config: FaultConfig, tracer=None):
        self.config = config
        self.calls = 0
        self.failures = 0
        self.stragglers = 0
        self.simulated_delay_s = 0.0
        self.tracer = NULL_TRACER if tracer is None else tracer
        self._sink = Tracer()

    @property
    def events(self):
        """``(kind, attempt, shard)`` per injected event, from the sink."""
        return [(e.kind.split(".", 1)[1], e.attrs["attempt"],
                 e.attrs["shard"]) for e in self._sink.events()]

    def _emit(self, kind: str, **attrs) -> None:
        self._sink.event(kind, **attrs)
        tr = self.tracer
        if tr.enabled:
            tr.event(kind, **attrs)
            tr.count(f"{kind}s")

    def _budget_left(self) -> bool:
        mf = self.config.max_failures
        return mf is None or self.failures < mf

    def _fail(self, attempt: int, shard: int):
        self.failures += 1
        self._emit("fault.failure", attempt=attempt, shard=shard)
        raise ShardFailure(attempt, shard)

    def on_shuffle(self, n_shards: int) -> None:
        """One shuffle attempt: maybe raise :class:`ShardFailure`, maybe log
        straggler events.  Called by the proxy before the real shuffle."""
        cfg = self.config
        attempt = self.calls
        self.calls += 1
        if attempt in cfg.fail_at and self._budget_left():
            self._fail(attempt, cfg.fail_shard % max(1, n_shards))
        if cfg.failure_probability <= 0 and cfg.straggler_probability <= 0:
            return
        for shard in range(max(1, n_shards)):
            rng = np.random.default_rng([cfg.seed, attempt, shard])
            u = float(rng.random())
            if u < cfg.failure_probability:
                if self._budget_left():
                    self._fail(attempt, shard)
            elif u < cfg.failure_probability + cfg.straggler_probability:
                self.stragglers += 1
                self.simulated_delay_s += cfg.straggler_delay_s
                self._emit("fault.straggler", attempt=attempt, shard=shard,
                           delay_s=cfg.straggler_delay_s)


class FaultInjectingEngine(MREngine):
    """Backend-agnostic injection proxy: ``inner``'s shuffle behind a
    :class:`FaultInjector`.

    The round drivers are the :class:`MREngine` base loops, so every
    shuffle is a host-level call the injector can interpose.  The shuffle
    itself and the layout decisions (``aligned_nodes``, ``node_ids``)
    delegate to the wrapped engine, so results equal running ``inner``
    directly whenever no fault fires.

    ``MREngine`` defines ``device``, ``cache_size`` and ``tracer`` as class
    attributes, which ``__getattr__`` would never delegate: the proxy
    adopts them from the wrapped engine explicitly.  Were ``device`` left
    at the class's CPU, a plan's prologue would move the inputs off the
    card and the shuffles would run the kernels' plain versions there.

    ``batchable`` is the one class attribute it does not adopt: a batch on
    the proxy runs its queries one after another, each shuffle attempt
    passing the injector, as the JAX package's proxy is not vmappable."""

    batchable = False

    def __init__(self, engine: MREngine, faults):
        self.inner = engine
        self.injector = (faults if isinstance(faults, FaultInjector)
                         else FaultInjector(faults))
        self.name = f"faulty-{engine.name}"
        self.n_shards = getattr(engine, "n_shards", 1)
        self.device = engine.device
        self.cache_size = engine.cache_size
        self.tracer = getattr(engine, "tracer", NULL_TRACER)
        if self.tracer.enabled and not self.injector.tracer.enabled:
            self.injector.tracer = self.tracer

    def aligned_nodes(self, n_nodes: int) -> int:
        return self.inner.aligned_nodes(n_nodes)

    def node_ids(self, n_nodes: int):
        return self.inner.node_ids(n_nodes)

    def __getattr__(self, attr):
        # Backend-specific attributes (shuffle_impl, route_log, ...)
        # resolve against the wrapped engine.
        if attr == "inner":              # not yet set: no recursion
            raise AttributeError(attr)
        return getattr(self.inner, attr)

    def shuffle(self, dests, payload, n_nodes: int, capacity: int):
        self.injector.on_shuffle(self.n_shards)
        return self.inner.shuffle(dests, payload, n_nodes, capacity)


def with_faults(engine: MREngine, faults) -> FaultInjectingEngine:
    """Wrap ``engine`` with a :class:`FaultConfig` (or a live
    :class:`FaultInjector`, to share attempt counters across drivers)."""
    return FaultInjectingEngine(engine, faults)


# ---------------------------------------------------------------------------
# Round-boundary checkpointing
# ---------------------------------------------------------------------------

def _leaf_kind(leaf) -> str:
    if isinstance(leaf, bool):
        return "bool"
    if isinstance(leaf, int):
        return "int"
    if isinstance(leaf, float):
        return "float"
    if isinstance(leaf, str):
        return "str"
    if isinstance(leaf, bytes):
        return "bytes"
    return "array"


def _cast_leaf(kind: str, arr: np.ndarray, info, device):
    if kind == "int":
        return int(arr)
    if kind == "float":
        return float(arr)
    if kind == "bool":
        return bool(arr)
    if kind == "str":
        return str(arr)
    if kind == "bytes":
        return bytes(arr)
    if info is None:                         # a numpy leaf stays numpy
        return arr
    return torch.from_numpy(arr).to(device=device,
                                    dtype=getattr(torch, info))


def _structure_record(structure):
    """A JSON record of a :func:`~repro_torch._tree.tree_flatten`
    structure: the port's counterpart of the JAX package's pickled
    treedef."""
    if structure is None or structure == "*":
        return structure
    kind, keys, children = structure
    rec = {"c": [_structure_record(c) for c in children]}
    if kind is dict:
        rec["t"], rec["k"] = "dict", list(keys)
    elif kind in (list, tuple):
        rec["t"] = kind.__name__
    else:
        rec["t"] = f"{kind.__module__}:{kind.__qualname__}"
    return rec


def _structure_of(rec):
    if rec is None or rec == "*":
        return rec
    t = rec["t"]
    children = [_structure_of(c) for c in rec["c"]]
    if t == "dict":
        return (dict, list(rec["k"]), children)
    if t in ("list", "tuple"):
        return ({"list": list, "tuple": tuple}[t], None, children)
    module, qualname = t.split(":")
    kind = importlib.import_module(module)
    for part in qualname.split("."):
        kind = getattr(kind, part)
    return (kind, None, children)


def plan_digest(plan: Plan) -> str:
    """Stable short digest of ``(plan.fingerprint, plan.shape_fingerprint)``
    — the on-disk half of the (plan fingerprint, round index) checkpoint
    key, equal to the JAX package's for the same plan parameters.  Two
    plans that would not share an executable never share a checkpoint
    directory."""
    return plan_token(plan)


class Checkpointer:
    """Round-boundary checkpoints keyed by (plan fingerprint, round index).

    On-disk layout (the step-atomic tmp-dir-then-rename protocol of
    :func:`repro_torch.train.checkpoint.save`, so a crash mid-save never
    corrupts the last durable checkpoint)::

        <directory>/plan_<digest>/step_<round:08d>/
            <i>_leaf_<i>.npy     # one per leaf of the state, on the host
            manifest.json        # shapes/dtypes, structure, leaf kinds

    The checkpointed tree is the full round-boundary state — the mailbox
    ``(payload, validity)``, the plan carry, and the functional
    :class:`~repro_torch.core.costmodel.CostAccum` — flattened in the JAX
    package's leaf order; the nest travels in the manifest as a JSON
    ``structure`` record next to a per-leaf kind tag, so Python scalars
    restore as scalars and tensors with their dtype.  Leaves are gathered
    logical arrays, so a restore may land on another engine or device.

    ``every`` is the ``checkpoint_every`` policy: :meth:`maybe_save`
    persists only when at least ``every`` rounds completed since the last
    durable checkpoint.  ``keep`` (optional) prunes the oldest checkpoints
    beyond the newest ``keep``.

    ``async_save=True`` routes saves through
    :class:`repro_torch.train.checkpoint.AsyncSaver`: the round loop is
    blocked only for the device→host copy (on the caller thread, so later
    rounds cannot change what is written); the ``.npy`` writes and the
    atomic publish run on a background thread.  One save may be outstanding
    at a time; the next save (or any read — :meth:`rounds` /
    :meth:`latest` / :meth:`load` — or an explicit :meth:`flush`) settles
    it first, accounting its bytes, emitting its ``ckpt.save`` event, and
    re-raising any background write error.
    """

    def __init__(self, directory, plan: Optional[Plan] = None, *,
                 every: int = 1, keep: Optional[int] = None,
                 tag: Optional[str] = None, tracer=None,
                 async_save: bool = False):
        if plan is None and tag is None:
            raise ValueError("Checkpointer needs a plan (fingerprint key) "
                             "or an explicit tag")
        if int(every) < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        digest = plan_digest(plan) if plan is not None else \
            hashlib.sha1(str(tag).encode("utf-8")).hexdigest()[:16]
        self.root = pathlib.Path(directory) / f"plan_{digest}"
        self.every = int(every)
        self.keep = None if keep is None else int(keep)
        self.saved_rounds = []
        self.bytes_written = 0
        self._last_saved = 0
        self.async_save = bool(async_save)
        self._saver = _ckpt.AsyncSaver() if self.async_save else None
        self._pending_round = None
        # ckpt.save / ckpt.restore sink; the recovery drivers re-wire this
        # to the engine's tracer when one is live
        self.tracer = NULL_TRACER if tracer is None else tracer

    # -- policy --------------------------------------------------------------
    def due(self, rounds_done: int) -> bool:
        """Whether ``rounds_done`` completed rounds warrant a checkpoint
        under the ``every`` policy (measured from the last durable save)."""
        return rounds_done - self._last_saved >= self.every

    def maybe_save(self, rounds_done: int, tree, meta=None) -> bool:
        """Checkpoint iff :meth:`due`; returns whether a save happened."""
        if not self.due(rounds_done):
            return False
        self.save(rounds_done, tree, meta=meta)
        return True

    # -- storage -------------------------------------------------------------
    def save(self, round_idx: int, tree, meta=None) -> str:
        """Persist ``tree`` as the round-``round_idx`` checkpoint
        (step-atomic; overwrites an existing checkpoint of the same round).

        Synchronous by default.  With ``async_save`` the device→host copy
        happens here but the disk write runs on the saver's background
        thread; the returned path is where the checkpoint *will* be
        published — settle with :meth:`flush` before reading it."""
        leaves, structure = tree_flatten(tree)
        kinds = [_leaf_kind(l) for l in leaves]
        flat = {f"leaf_{i:05d}": l for i, l in enumerate(leaves)}
        extra = {"structure": _structure_record(structure),
                 "tensor_dtypes": [str(l.dtype).removeprefix("torch.")
                                   if isinstance(l, torch.Tensor) else None
                                   for l in leaves],
                 "leaf_kinds": kinds,
                 **(meta or {})}
        if self.async_save:
            self._settle()
            self._saver.save_async(str(self.root), int(round_idx), flat,
                                   extra_meta=extra)
            self._pending_round = int(round_idx)
            path = str(self.root / f"step_{int(round_idx):08d}")
        else:
            path = _ckpt.save(str(self.root), int(round_idx), flat,
                              extra_meta=extra)
            self._account(int(round_idx), path)
        self.saved_rounds.append(int(round_idx))
        self._last_saved = int(round_idx)
        return path

    def _account(self, round_idx: int, path) -> None:
        """Fold one *published* checkpoint into the byte counters, the
        tracer, and the ``keep`` pruning policy."""
        nbytes = sum(p.stat().st_size
                     for p in pathlib.Path(path).glob("*.npy"))
        self.bytes_written += nbytes
        if self.tracer.enabled:
            self.tracer.event("ckpt.save", round=int(round_idx),
                              bytes=nbytes)
            self.tracer.count("ckpt.saves")
        if self.keep is not None:
            self._prune()

    def _settle(self) -> None:
        if self._saver is None:
            return
        self._saver.wait()           # joins the writer; re-raises its error
        if self._pending_round is not None:
            self._account(self._pending_round, self._saver.last_path)
            self._pending_round = None

    def flush(self) -> None:
        """Block until any outstanding async save is durably published and
        accounted (no-op for the synchronous default).  Re-raises an error
        the background writer hit."""
        self._settle()

    def _prune(self) -> None:
        steps = sorted(self.rounds())
        for r in steps[:max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.root / f"step_{r:08d}", ignore_errors=True)

    def rounds(self):
        """Round indices with a durable checkpoint, ascending."""
        self._settle()
        if not self.root.exists():
            return []
        return sorted(int(p.name.split("_")[1]) for p in self.root.iterdir()
                      if p.is_dir() and p.name.startswith("step_"))

    def latest(self) -> Optional[int]:
        """Newest durable round index (None when nothing was saved)."""
        self._settle()
        return _ckpt.latest_step(str(self.root))

    def load(self, round_idx: int, device="cuda") -> Tuple[Any, Dict]:
        """Restore the round-``round_idx`` checkpoint: returns ``(tree,
        meta)`` with tensor leaves on ``device`` in their saved dtype and
        scalar leaves cast back to their Python types."""
        self._settle()
        device = as_device(device, "checkpoint restore")
        final = self.root / f"step_{int(round_idx):08d}"
        manifest = json.loads((final / "manifest.json").read_text())
        meta = manifest["meta"]
        leaves = []
        for i, (kind, info) in enumerate(zip(meta["leaf_kinds"],
                                             meta["tensor_dtypes"])):
            entry = manifest["tensors"][f"leaf_{i:05d}"]
            arr = np.load(final / entry["file"], allow_pickle=False)
            leaves.append(_cast_leaf(kind, arr, info, device))
        if self.tracer.enabled:
            self.tracer.event("ckpt.restore", round=int(round_idx),
                              stage_index=meta.get("stage_index"))
            self.tracer.count("ckpt.restores")
        return tree_unflatten(_structure_of(meta["structure"]), leaves), meta


# ---------------------------------------------------------------------------
# Recovery drivers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RecoveryReport:
    """What recovery actually did — the observability half of the story."""

    restarts: int = 0
    rounds_replayed: int = 0
    checkpoints_written: int = 0
    checkpoint_bytes: int = 0
    failures_injected: int = 0
    stragglers_injected: int = 0
    simulated_delay_s: float = 0.0
    resumed_at_round: Optional[int] = None


def realign_mailbox(box: Mailbox, engine: MREngine) -> Mailbox:
    """Re-pad a restored mailbox's node axis to ``engine``'s layout
    granularity (``aligned_nodes``) and move it to the engine's device.

    Appending all-invalid node rows is semantics-neutral: round functions
    emit -1 ("no item") for invalid slots, and the shape-scheduled stages
    re-derive their own (V_r, M_r) targets through ``engine.aligned_nodes``
    at execute time."""
    dev = engine.device
    box = Mailbox(payload=tree_map(lambda l: torch.as_tensor(l, device=dev),
                                   box.payload),
                  valid=torch.as_tensor(box.valid, device=dev))
    V = box.n_nodes
    pad = engine.aligned_nodes(V) - V
    if pad == 0:
        return box

    def pad_leaf(leaf):
        return torch.cat([leaf, leaf.new_zeros((pad,) + leaf.shape[1:])])

    return Mailbox(payload=tree_map(pad_leaf, box.payload),
                   valid=pad_leaf(box.valid))


def elastic_engine(n_shards: int, group=None, shuffle_impl: str = "dense",
                   device="cuda"):
    """A :class:`~repro_torch.core.engine.ShardedEngine` over the first
    ``n_shards`` ranks of ``group`` (the default group when None), with
    that group's backend, on ``device``: the engine an elastic resume runs
    on.  Raises (healthy against requested) rather than silently shrinking
    the resume.

    Every rank of ``group`` must call it, since it makes the new group
    (``torch.distributed.new_group``); the ranks left out get None and take
    no part in the resume."""
    import torch.distributed as dist
    from .engine import ShardedEngine
    if int(n_shards) < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "elastic_engine needs a torch.distributed process group: call "
            "torch.distributed.init_process_group first")
    world = dist.get_world_size(group)
    if int(n_shards) > world:
        raise ValueError(
            f"elastic_engine: requested {n_shards} shards but only {world} "
            f"ranks are healthy — refusing to silently shrink the resume "
            f"topology")
    ranks = [r if group is None else dist.get_global_rank(group, r)
             for r in range(int(n_shards))]
    sub = dist.new_group(ranks, backend=dist.get_backend(group))
    if sub is dist.GroupMember.NON_GROUP_MEMBER:
        return None
    return ShardedEngine(group=sub, shuffle_impl=shuffle_impl, device=device)


def _cumulative_rounds(plan: Plan):
    out, c = [], 0
    for s in plan.stages:
        c += s.rounds
        out.append(c)
    return out


def _fresh_state(plan: Plan, inputs, key, device) -> PlanState:
    """The one query's state before the first stage, as a batch of one."""
    _check_inputs(plan, tuple(inputs))
    return initial_state(plan, batch_of_one(tuple(inputs)),
                         [plan.split_key(key)], device)


def _state_tree(state: PlanState):
    """What a checkpoint holds: the one query's state without the batch
    axis, leaf for leaf the JAX package's."""
    return row_of({"box": state.box, "carry": state.carry,
                   "accum": state.accum})


def _restore(checkpointer: "Checkpointer", round_idx: int, engine):
    """Load a checkpoint onto ``engine``'s device, mailbox realigned, as
    a batch of one."""
    tree, meta = checkpointer.load(round_idx, device=engine.device)
    box = tree["box"]
    if box is not None:
        box = realign_mailbox(box, engine)
    tree = batch_of_one({**tree, "box": box})
    return PlanState(box=tree["box"], carry=tree["carry"],
                     accum=tree["accum"]), meta


def _wire_tracer(checkpointer: Optional[Checkpointer], tr) -> None:
    """Point an un-traced checkpointer at the engine's live tracer so
    ckpt.* events land in the same stream as the rounds they snapshot."""
    if (checkpointer is not None and tr.enabled
            and not checkpointer.tracer.enabled):
        checkpointer.tracer = tr


def _staged_apply(plan: Plan, engine, i: int, state: PlanState,
                  tr) -> PlanState:
    """One stage, under a ``plan.stage`` span when a tracer is live."""
    if not tr.enabled:
        return plan.stages[i].apply(engine, state)
    return _traced_apply(plan, engine, i, state, tr)


def _save_stage(checkpointer, cum, plan, i, state) -> bool:
    return checkpointer.maybe_save(
        cum[i], _state_tree(state),
        meta={"stage_index": i, "plan": plan.name, "rounds_done": cum[i]})


def _apply_stages(plan: Plan, engine, state: PlanState, start: int,
                  checkpointer: Optional[Checkpointer],
                  report: Optional[RecoveryReport] = None) -> PlanState:
    """Run stages ``start..`` with round-boundary checkpoints (the body of
    ``execute_plan(checkpointer=...)``)."""
    cum = _cumulative_rounds(plan)
    tr = getattr(engine, "tracer", NULL_TRACER)
    _wire_tracer(checkpointer, tr)
    for i in range(start, len(plan.stages)):
        state = _staged_apply(plan, engine, i, state, tr)
        if checkpointer is not None:
            saved = _save_stage(checkpointer, cum, plan, i, state)
            if saved and report is not None:
                report.checkpoints_written += 1
    return state


def _drive(plan: Plan, base_engine, eng, state: PlanState, start: int,
           inputs, key, checkpointer: Optional[Checkpointer],
           max_restarts: int, report: RecoveryReport) -> PlanState:
    """The recovery loop: execute, and on an injected fault replay from the
    last durable round-boundary checkpoint (or from scratch)."""
    cum = _cumulative_rounds(plan)
    done = cum[start - 1] if start > 0 and cum else 0
    tr = getattr(eng, "tracer", NULL_TRACER)
    _wire_tracer(checkpointer, tr)
    with tr.span("plan.execute", plan=plan.name, digest=plan_token(plan),
                 backend=getattr(eng, "name", "?")):
        while True:
            try:
                for i in range(start, len(plan.stages)):
                    state = _staged_apply(plan, eng, i, state, tr)
                    done = cum[i]
                    if checkpointer is not None:
                        if _save_stage(checkpointer, cum, plan, i, state):
                            report.checkpoints_written += 1
                return state
            except FaultError:
                report.restarts += 1
                if report.restarts > max_restarts:
                    raise
                last = (checkpointer.latest()
                        if checkpointer is not None else None)
                if last is None:
                    state = _fresh_state(plan, inputs, key,
                                         base_engine.device)
                    start = 0
                    report.rounds_replayed += done
                    done = 0
                else:
                    state, meta = _restore(checkpointer, last, base_engine)
                    start = int(meta["stage_index"]) + 1
                    report.rounds_replayed += max(0, done - int(last))
                    done = int(last)
                if tr.enabled:
                    tr.event("recover.restart", restarts=report.restarts,
                             from_round=done)
                    tr.count("recover.restarts")


def _finish(plan, state, report, eng, checkpointer):
    outputs = row_of(plan.epilogue(state))
    if isinstance(eng, FaultInjectingEngine):
        inj = eng.injector
        report.failures_injected = inj.failures
        report.stragglers_injected = inj.stragglers
        report.simulated_delay_s = inj.simulated_delay_s
    if checkpointer is not None:
        checkpointer.flush()         # settle an outstanding async save
        report.checkpoint_bytes = checkpointer.bytes_written
    return outputs, report


def run_plan_with_recovery(plan: Plan, engine: MREngine, inputs,
                           key=None, *, faults=None,
                           checkpointer: Optional[Checkpointer] = None,
                           max_restarts: int = 8):
    """Execute ``plan`` on ``engine`` under fault injection with
    round-boundary checkpointing and replay recovery.

    Returns ``(outputs, RecoveryReport)`` where ``outputs`` is bit-identical
    (values *and* cost accounting) to a fault-free ``execute_plan(plan,
    engine, inputs, key)``: the accumulator is part of every checkpoint, so
    replayed rounds are counted exactly once.  ``max_restarts`` bounds
    replays; the fault that exceeds it propagates (checkpoints already
    written stay durable — hand the directory to :func:`resume_plan`, on
    this or another engine)."""
    eng = with_faults(engine, faults) if faults is not None else engine
    report = RecoveryReport()
    state = _fresh_state(plan, inputs, key, engine.device)
    state = _drive(plan, engine, eng, state, 0, inputs, key,
                   checkpointer, int(max_restarts), report)
    return _finish(plan, state, report, eng, checkpointer)


def resume_plan(plan: Plan, engine: MREngine, inputs, key=None, *,
                checkpointer: Checkpointer, at_round: Optional[int] = None,
                faults=None, max_restarts: int = 8):
    """Restart a checkpointed program, possibly on another engine.

    Loads the newest checkpoint under ``checkpointer`` (or the explicit
    ``at_round``) onto ``engine``'s device, re-pads the mailbox through
    :func:`realign_mailbox`, and drives the remaining stages.
    ``inputs``/``key`` must be the originals — they are only consulted if a
    later fault forces a from-scratch replay.  Returns ``(outputs,
    RecoveryReport)`` bit-identical to the fault-free run."""
    last = at_round if at_round is not None else checkpointer.latest()
    if last is None:
        raise ValueError(
            f"resume_plan: no checkpoint under {checkpointer.root} — "
            f"run_plan_with_recovery writes them")
    state, meta = _restore(checkpointer, last, engine)
    start = int(meta["stage_index"]) + 1
    eng = with_faults(engine, faults) if faults is not None else engine
    report = RecoveryReport(resumed_at_round=int(last))
    state = _drive(plan, engine, eng, state, start, inputs, key,
                   checkpointer, int(max_restarts), report)
    return _finish(plan, state, report, eng, checkpointer)


__all__ = [
    "FaultConfig", "FaultError", "FaultInjector", "FaultInjectingEngine",
    "ShardFailure", "with_faults",
    "Checkpointer", "plan_digest", "RecoveryReport",
    "run_plan_with_recovery", "resume_plan",
    "realign_mailbox", "elastic_engine",
]

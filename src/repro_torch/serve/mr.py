"""Continuous-batching query service over the plan cache.

The port of the JAX package's ``repro.serve.mr``.  ``ServeEngine`` applies
the paper's Theorem 4.2 discipline to *token* rounds; this module applies
it to *queries* over the plan/compile/execute stack: every algorithm family
the engine serves — sort, multisearch, hull2d/hull3d, LP, prefix, funnel —
is a cached ``Executable``, and the service turns concurrent single-query
traffic into batched dispatches.

The Thm 4.2 mapping, piece by piece:

- **FIFO admission** — requests join a per-plan-fingerprint FIFO queue in
  arrival order and leave it in arrival order;
- **bounded per-round I/O** — each dispatch feeds at most ``max_batch``
  queries (the M analogue) into one ``Executable.batch`` call;
- **round boundaries** — dispatch happens when a queue reaches
  ``max_batch`` (the window fills) or its oldest request has waited
  ``max_wait_ms`` (the latency deadline);
- **backpressure** — when ``max_pending`` requests already wait, or
  admitting a cold plan fingerprint would thrash the engine's LRU plan
  cache, ``submit`` raises :class:`QueueFull` with a ``retry_after_ms``
  hint instead of growing an invisible backlog.

Everything is synchronous and deterministic: there is no event loop, the
caller pumps :meth:`QueryService.step` (or lets ``submit`` dispatch full
windows and :meth:`Ticket.wait` flush stragglers), and time comes from an
injectable ``clock`` — ``time.monotonic`` in production,
:class:`VirtualClock` under test.

On a batchable engine (``LocalEngine``) a dispatch of ``k`` live queries
runs as one ``Executable.batch(k)`` round program, each round one shuffle
for the batch.  Where the JAX package pads the window to ``max_batch`` to
reuse one lowered program, the port compiles nothing, so it runs only the
``k`` live rows.  On an engine that is not batchable (the fault-injection
proxy) a dispatch pads the window to ``max_batch`` by repeating its last
query and runs every lane, pad rows included, one after another, as the
JAX package's loop does: the shuffle attempts, and so the injected faults,
fall on the same dispatches as there.  ``pad_slots``, ``coalesced`` and
:meth:`stats` account every dispatch as a window of ``max_batch`` lanes,
as the JAX package does, and ``stats()["traces"]`` counts runs of the
round program (the port lowers nothing).  Results stay on the engine's
device.

>>> import torch
>>> from repro_torch.core import LocalEngine, sort_plan
>>> from repro_torch.serve import QueryService, VirtualClock
>>> clock = VirtualClock()
>>> svc = QueryService(LocalEngine(device="cpu"), max_batch=2,
...                    max_wait_ms=5.0, clock=clock)
>>> plan = sort_plan(4, 4)
>>> t1 = svc.submit(plan, torch.tensor([3., 1., 2., 0.]))
>>> t1.done                              # window not full: still queued
False
>>> t2 = svc.submit(plan, torch.tensor([9., 8., 7., 6.]))  # fills the window
>>> t1.done and t2.done                  # -> one batched dispatch of both
True
>>> t1.wait().values.tolist()
[0.0, 1.0, 2.0, 3.0]
>>> t3 = svc.submit(plan, torch.tensor([5., 4., 6., 7.]))  # partial window
>>> _ = clock.advance(0.005)             # ... the 5 ms deadline passes
>>> svc.step()                           # deadline sweep dispatches it
1
>>> float(t3.latency) == 0.005
True
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._tree import tree_flatten, tree_unflatten
from ..core.plan import Plan, torch_dtype
from ..obs import NULL_TRACER


class VirtualClock:
    """A deterministic, manually-advanced clock (seconds).

    Drop-in for the ``clock`` slot of :class:`QueryService` and
    ``ServeEngine``: calling it returns the current virtual time and
    :meth:`advance` moves it forward — nothing else does, so latency and
    deadline behavior under test is exact.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def __call__(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        """Move time forward by ``dt`` seconds and return the new time."""
        if dt < 0:
            raise ValueError(f"clocks do not run backwards (dt={dt})")
        self._t += float(dt)
        return self._t


class QueueFull(RuntimeError):
    """Admission rejected: the service is at its Thm 4.2 window bound.

    Carries ``retry_after_ms`` — when capacity should free (one batching
    window) — and ``reason`` — which bound fired (``"pending"`` for the
    inflight budget, ``"plan-cache"`` for the LRU thrash guard)."""

    def __init__(self, reason: str, detail: str, retry_after_ms: float):
        super().__init__(f"{detail} (retry after {retry_after_ms:.1f} ms)")
        self.reason = reason
        self.retry_after_ms = float(retry_after_ms)


class DispatchError(RuntimeError):
    """A query's dispatch failed terminally (its retry budget is spent).

    Carried on :attr:`Ticket.error` and raised by :meth:`Ticket.wait`;
    ``__cause__`` is the underlying engine exception (e.g. an injected
    :class:`repro_torch.core.recovery.ShardFailure`), ``attempts`` how many
    dispatches were tried."""

    def __init__(self, plan_name: str, attempts: int,
                 cause: BaseException):
        super().__init__(
            f"dispatch of plan {plan_name!r} failed after {attempts} "
            f"attempt(s): {cause!r}")
        self.plan_name = plan_name
        self.attempts = int(attempts)
        self.__cause__ = cause


@dataclasses.dataclass
class Ticket:
    """One submitted query: its identity, payload, and timing trace.

    ``submitted_at`` / ``dispatched_at`` / ``completed_at`` are stamps of
    the service clock; ``batch_occupancy`` records how many live queries
    shared its dispatch; ``value`` is the per-query result, equal bit for
    bit to a sequential call.  A failed dispatch requeues the ticket
    (``retries`` counts attempts so far) until the service's
    ``max_retries`` budget is spent, after which the ticket completes
    exceptionally: ``done`` with ``error`` a :class:`DispatchError`."""

    uid: int
    plan_name: str
    submitted_at: float
    inputs: Tuple = ()
    key: Any = None
    dispatched_at: Optional[float] = None
    completed_at: Optional[float] = None
    batch_occupancy: Optional[int] = None
    value: Any = None
    done: bool = False
    error: Optional[BaseException] = None
    retries: int = 0
    _service: Any = dataclasses.field(default=None, repr=False)
    _plan_key: Any = dataclasses.field(default=None, repr=False)

    @property
    def failed(self) -> bool:
        """Completed exceptionally (``error`` holds the DispatchError)."""
        return self.error is not None

    @property
    def latency(self) -> Optional[float]:
        """completion - submission in clock seconds (None while pending)."""
        if self.completed_at is None:
            return None
        return self.completed_at - self.submitted_at

    @property
    def queue_delay(self) -> Optional[float]:
        """dispatch - submission in clock seconds (None while queued)."""
        if self.dispatched_at is None:
            return None
        return self.dispatched_at - self.submitted_at

    def wait(self):
        """Force completion and return the result value: dispatch this
        ticket's plan queue (repeatedly, if others are ahead) until the
        query has run.  Terminates even under persistent dispatch failures
        (each attempt burns retry budget) and raises the
        :class:`DispatchError` of a failed ticket."""
        while not self.done:
            self._service._dispatch(self._plan_key, cause="wait")
        if self.error is not None:
            raise self.error
        return self.value


class QueryService:
    """Continuous-batching front end over ``engine.compile``.

    ``submit(plan, *inputs, key=...)`` enqueues one query and returns a
    :class:`Ticket`; concurrent same-fingerprint queries coalesce into one
    ``Executable.batch`` call, dispatched when the window fills or the
    oldest request exceeds ``max_wait_ms`` (pumped by :meth:`step`).

    Admission control: at most ``max_pending`` queries wait across all
    queues, and a query for a *cold* plan fingerprint is rejected while
    the distinct plans in flight would thrash the engine's LRU plan cache.
    Both rejections raise :class:`QueueFull` with a retry-after hint.
    ``warmup(plans)`` compiles the hot fingerprints and runs each once.
    """

    def __init__(self, engine, *, max_batch: int = 16,
                 max_wait_ms: float = 5.0, max_pending: int = 256,
                 max_retries: int = 2,
                 clock: Callable[[], float] = time.monotonic,
                 tracer=None):
        if int(max_batch) < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if int(max_pending) < int(max_batch):
            raise ValueError(
                f"max_pending={max_pending} below max_batch={max_batch}: "
                f"the admission window could never fill one batch")
        if int(max_retries) < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.engine = engine
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.max_pending = int(max_pending)
        self.max_retries = int(max_retries)
        self.clock = clock
        # serve.* lifecycle events; defaults to the engine's tracer so one
        # Tracer sees the whole stack (rounds, dispatches, faults)
        self.tracer = (tracer if tracer is not None
                       else getattr(engine, "tracer", NULL_TRACER))
        self._queues: "OrderedDict[Any, deque]" = OrderedDict()
        self._plans: Dict[Any, Plan] = {}
        self._exes: Dict[Any, Any] = {}
        self._wait_ms: Dict[Any, float] = {}   # per-plan deadline overrides
        self._uid = 0
        self.finished: List[Ticket] = []
        # service-level counters (host ints; stats() summarizes them)
        self.submitted = 0
        self.completed = 0
        self.rejected = 0
        self.failed = 0              # tickets completed exceptionally
        self.requeued = 0            # retry requeues after failed dispatches
        self.dispatches = 0
        self.coalesced = 0           # live queries over all dispatches
        self.pad_slots = 0           # unfilled lanes of max_batch windows

    # -- introspection -------------------------------------------------------
    @property
    def pending(self) -> int:
        """Queries admitted but not yet dispatched, across all queues."""
        return sum(len(q) for q in self._queues.values())

    def _active_plan_keys(self) -> List:
        return [pk for pk, q in self._queues.items() if q]

    def _deadline_ms(self, pk) -> float:
        """The dispatch deadline for one plan queue: its registered
        ``max_wait_ms`` override, else the service default."""
        return self._wait_ms.get(pk, self.max_wait_ms)

    # -- admission -----------------------------------------------------------
    def register(self, plan: Plan, *, max_wait_ms: Optional[float] = None
                 ) -> None:
        """Register per-plan serving policy ahead of traffic.

        ``max_wait_ms`` overrides the service-wide dispatch deadline for
        this plan's queue (a latency-sensitive family can dispatch partial
        windows sooner than a throughput family sharing the service).
        ``None`` clears the override."""
        pk = self.engine.plan_key(plan)
        self._plans.setdefault(pk, plan)
        if max_wait_ms is None:
            self._wait_ms.pop(pk, None)
        else:
            if float(max_wait_ms) < 0:
                raise ValueError(
                    f"max_wait_ms must be >= 0, got {max_wait_ms}")
            self._wait_ms[pk] = float(max_wait_ms)

    def submit(self, plan: Plan, *inputs, key=None,
               max_wait_ms: Optional[float] = None) -> Ticket:
        """Admit one query for ``plan`` (FIFO per fingerprint) or raise
        :class:`QueueFull`.

        ``key`` is the query's random source (an int seed, a generator, or
        sample indices; see ``Plan.split_key``); None resolves to the
        plan's ``default_seed`` *here*, so a coalesced query sees exactly
        the key a sequential ``exe(*inputs, key=None)`` would.  A queue
        that reaches ``max_batch`` dispatches from inside ``submit``;
        deadline dispatch of partial windows happens in :meth:`step`."""
        now = self.clock()
        tr = self.tracer
        if self.pending >= self.max_pending:
            self.rejected += 1
            if tr.enabled:
                tr.event("serve.reject", plan=plan.name, reason="pending")
                tr.count("serve.rejects")
            raise QueueFull(
                "pending",
                f"admission window full: {self.pending} queries pending "
                f">= max_pending={self.max_pending}", self.max_wait_ms)
        pk = self.engine.plan_key(plan)
        if max_wait_ms is not None:
            self.register(plan, max_wait_ms=max_wait_ms)
        if pk not in self._queues and not self.engine.plan_cached(plan):
            # LRU thrash guard: compiling a cold fingerprint while this
            # many distinct plans have queued work would evict an
            # executable another admitted query is about to run.
            cap = self.engine.cache_info().maxsize
            active = len(self._active_plan_keys())
            if active + 1 > max(1, cap):
                self.rejected += 1
                if tr.enabled:
                    tr.event("serve.reject", plan=plan.name,
                             reason="plan-cache")
                    tr.count("serve.rejects")
                raise QueueFull(
                    "plan-cache",
                    f"plan-cache thrash: {active} distinct plans already "
                    f"queued, cache holds {cap}", self.max_wait_ms)
        if key is None:
            key = plan.default_seed
        self._uid += 1
        ticket = Ticket(uid=self._uid, plan_name=plan.name,
                        submitted_at=now, inputs=tuple(inputs), key=key,
                        _service=self, _plan_key=pk)
        self._plans[pk] = plan
        self._queues.setdefault(pk, deque()).append(ticket)
        self.submitted += 1
        if tr.enabled:
            tr.event("serve.submit", plan=plan.name, uid=ticket.uid,
                     pending=self.pending)
            tr.count("serve.submits")
        if len(self._queues[pk]) >= self.max_batch:
            self._dispatch(pk, cause="window")
        return ticket

    def warmup(self, plans: Sequence[Plan],
               examples: Optional[Sequence[Tuple]] = None) -> Dict[str, int]:
        """Compile the hot fingerprints (populating the engine's plan cache)
        and run each once on example inputs (``examples[i]``, or
        synthesized from the plan's ``input_spec``), so the first dispatch
        of real traffic meets built kernels and a warm allocator.  Returns
        ``{plan.name: trace_count}``."""
        report = {}
        for i, plan in enumerate(plans):
            ex = (examples[i] if examples is not None
                  else _synthesize_inputs(plan))
            pk = self.engine.plan_key(plan)
            exe = self.engine.compile(plan)
            self._plans.setdefault(pk, plan)
            self._exes[pk] = exe
            stacked = tuple(torch.as_tensor(x, device=self.engine.device)[None]
                            for x in ex)
            self._run_window(exe, stacked, [plan.default_seed])
            report[plan.name] = exe.trace_count
        _synchronize(self.engine.device)
        return report

    # -- dispatch ------------------------------------------------------------
    def step(self, now: Optional[float] = None) -> int:
        """One driver tick: dispatch every queue that is due (window full,
        or the oldest request past its queue's deadline).  Returns the
        number of queries completed this tick."""
        now = self.clock() if now is None else now
        tr = self.tracer
        done = 0
        for pk in list(self._queues):
            q = self._queues[pk]
            while len(q) >= self.max_batch:
                done += self._dispatch(pk, cause="window")
            deadline = self._deadline_ms(pk)
            if q and (now - q[0].submitted_at) * 1e3 >= deadline:
                if tr.enabled:
                    tr.event("serve.deadline",
                             plan=q[0].plan_name,
                             waited_ms=(now - q[0].submitted_at) * 1e3,
                             deadline_ms=deadline)
                done += self._dispatch(pk, cause="deadline")
        return done

    def drain(self) -> int:
        """Dispatch everything queued, deadlines notwithstanding (the
        end-of-traffic flush).  Returns the number resolved — successes
        plus tickets that completed exceptionally.  Terminates even when
        the engine fails every dispatch: each failure burns one retry per
        affected ticket."""
        done = 0
        while self.pending:
            for pk in self._active_plan_keys():
                done += self._dispatch(pk, cause="drain")
        return done

    def dispatch_oldest(self) -> int:
        """Dispatch the queue whose head has waited longest (the
        closed-loop client's recovery action after :class:`QueueFull`).
        Returns the number completed (0 when idle)."""
        heads = [(q[0].submitted_at, pk)
                 for pk, q in self._queues.items() if q]
        if not heads:
            return 0
        _, pk = min(heads)
        return self._dispatch(pk, cause="pump")

    def _dispatch(self, pk, cause: str = "pump") -> int:
        """Coalesce up to ``max_batch`` queries from one queue into one
        ``Executable.batch(k)`` call over the ``k`` live queries, stacked
        on the engine's device, and demultiplex the stacked outputs."""
        q = self._queues.get(pk)
        if not q:
            return 0
        k = min(len(q), self.max_batch)
        batch = [q.popleft() for _ in range(k)]
        dispatched_at = self.clock()
        try:
            exe = self._exes.get(pk)
            if exe is None:
                exe = self._exes[pk] = self.engine.compile(self._plans[pk])
            dev = self.engine.device
            stacked = tuple(
                torch.stack([torch.as_tensor(t.inputs[i], device=dev)
                             for t in batch])
                for i in range(len(batch[0].inputs)))
            out = self._run_window(exe, stacked, [t.key for t in batch])
            leaves, structure = tree_flatten(out)
        except Exception as e:
            return self._fail_or_requeue(pk, batch, e, cause)
        completed_at = self.clock()
        for i, t in enumerate(batch):
            t.value = tree_unflatten(structure, [leaf[i] for leaf in leaves])
            t.dispatched_at = dispatched_at
            t.completed_at = completed_at
            t.batch_occupancy = k
            t.done = True
        self.finished.extend(batch)
        self.dispatches += 1
        self.coalesced += k
        self.pad_slots += self.max_batch - k
        self.completed += k
        tr = self.tracer
        if tr.enabled:
            tr.event("serve.dispatch", _dur=completed_at - dispatched_at,
                     plan=batch[0].plan_name, cause=cause, occupancy=k,
                     pad=self.max_batch - k)
            tr.count("serve.dispatches")
            tr.count("serve.completed", k)
            tr.observe("serve.occupancy", k)
            for t in batch:
                tr.observe("serve.wait_ms",
                           (t.dispatched_at - t.submitted_at) * 1e3)
        return k

    def _run_window(self, exe, stacked: Tuple, keys: List):
        """One dispatch's program over ``k`` stacked queries: ``batch(k)``
        on a batchable engine; elsewhere the window padded to
        ``max_batch`` with copies of its last query, every lane run, as
        the JAX package runs a window on an engine it cannot ``vmap``.
        Rows ``[:k]`` of the outputs are the live queries'."""
        k = len(keys)
        if getattr(self.engine, "batchable", False):
            return exe.batch(k)(*stacked, keys=keys)
        B = self.max_batch
        padded = tuple(torch.cat([x, x[-1:].expand((B - k,) + x.shape[1:])])
                       for x in stacked)
        return exe.batch(B)(*padded, keys=list(keys) + [keys[-1]] * (B - k))

    def _fail_or_requeue(self, pk, batch: List[Ticket],
                         cause: Exception,
                         dispatch_cause: str = "pump") -> int:
        """Retry policy after a failed dispatch: each popped ticket burns
        one attempt; those within budget requeue at the *front* of their
        queue in original order (FIFO preserved), those past
        ``max_retries`` complete exceptionally with a
        :class:`DispatchError`.  Never raises.  Returns the number of
        tickets resolved (failed)."""
        now = self.clock()
        keep, dead = [], []
        for t in batch:
            t.retries += 1
            if t.retries > self.max_retries:
                t.error = DispatchError(t.plan_name, t.retries, cause)
                t.completed_at = now
                t.done = True
                dead.append(t)
            else:
                keep.append(t)
        self._queues[pk].extendleft(reversed(keep))
        self.requeued += len(keep)
        self.failed += len(dead)
        self.finished.extend(dead)
        tr = self.tracer
        if tr.enabled:
            tr.event("serve.dispatch_error", plan=batch[0].plan_name,
                     cause=dispatch_cause, batch=len(batch),
                     error=type(cause).__name__)
            tr.count("serve.dispatch_errors")
            if keep:
                tr.event("serve.requeue", plan=batch[0].plan_name,
                         count=len(keep))
                tr.count("serve.requeues", len(keep))
            for t in dead:
                tr.event("serve.fail", plan=t.plan_name, uid=t.uid,
                         attempts=t.retries)
                tr.count("serve.failures")
        return len(dead)

    # -- reporting -----------------------------------------------------------
    def trace_counts(self) -> Dict[str, int]:
        """Per-plan run counts of the executables this service has driven
        (``Executable.trace_count``: the port counts runs, not
        lowerings)."""
        return {self._plans[pk].name: exe.trace_count
                for pk, exe in self._exes.items()}

    def stats(self) -> Dict[str, Any]:
        """Service-level counters plus latency percentiles (clock seconds)
        over finished queries and the engine's plan-cache counters."""
        lat = np.asarray([t.latency for t in self.finished], np.float64)
        return {
            "submitted": self.submitted, "completed": self.completed,
            "rejected": self.rejected, "pending": self.pending,
            "failed": self.failed, "requeued": self.requeued,
            "dispatches": self.dispatches,
            "mean_occupancy": (self.coalesced / self.dispatches
                               if self.dispatches else None),
            "pad_fraction": (self.pad_slots
                             / (self.dispatches * self.max_batch)
                             if self.dispatches else None),
            "p50_latency_s": float(np.percentile(lat, 50)) if lat.size
            else None,
            "p99_latency_s": float(np.percentile(lat, 99)) if lat.size
            else None,
            "cache": self.engine.cache_info()._asdict(),
            "traces": self.trace_counts(),
        }


def _synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _synthesize_inputs(plan: Plan) -> Tuple:
    """Deterministic example inputs for :meth:`QueryService.warmup`, built
    from the plan's declared ``input_spec`` (shape, dtype) pairs: a small
    non-negative ramp per input (dtype None: float32), as the JAX package
    builds them.  Plans without a spec need explicit ``examples``."""
    if plan.input_spec is None:
        raise ValueError(
            f"plan {plan.name!r} declares no input_spec; pass warmup "
            f"examples explicitly")
    out = []
    for i, spec in enumerate(plan.input_spec):
        if spec is None:
            raise ValueError(
                f"plan {plan.name!r} input {i} is unspecified; pass warmup "
                f"examples explicitly")
        shape, dtype = spec
        dtype = torch.float32 if dtype is None else torch_dtype(dtype)
        size = int(np.prod(shape)) if len(shape) else 1
        ramp = (torch.arange(size, dtype=torch.int32) % 7).to(dtype)
        out.append(ramp.reshape(shape))
    return tuple(out)


__all__ = ["DispatchError", "QueryService", "Ticket", "QueueFull",
           "VirtualClock"]

"""Typed spans and events in a bounded ring buffer: the `Tracer` core.

The recording half of ``repro_torch.obs``, the port of the JAX package's
``repro.obs.trace``: a process-local, injectable :class:`Tracer` that every
layer of the port reports into —

- ``engine.round`` events from ``MREngine.run_round`` and the plans' entry
  stages (declared vs measured (V_r, M_r), per-round ``RoundStats``, host
  wall time);
- ``plan.execute`` / ``plan.stage`` spans from
  :func:`repro_torch.core.plan.execute_plan` (plan digest, declared
  schedule, measured round deltas);
- ``exe.call`` / ``cache.hit`` / ``cache.miss`` from the query API;
- ``shuffle.route`` from the kernel-vs-dense decision of ``LocalEngine``;
- ``serve.*`` dispatch, queue and retry lifecycle from
  :class:`repro_torch.serve.QueryService`;
- ``fault.*`` / ``ckpt.*`` / ``recover.*`` from
  :mod:`repro_torch.core.recovery`.

PyTorch runs eagerly: nothing is ever traced, so every event records (the
JAX tracer drops events made while jax traces; there is no such state
here).  Attribute values become host scalars at record time: a 0-d tensor
on the card is read back with ``.item()``, a host sync, which is the
documented cost of opting into tracing.  The default hook everywhere is
:data:`NULL_TRACER`, and every call site guards with ``tracer.enabled``, so
an untraced run does no tracing work and adds no sync.

>>> tr = Tracer(clock=iter(range(100)).__next__)
>>> with tr.span("plan.stage", plan="sort", stage="entry"):
...     tr.event("engine.round", round=0, items_sent=4)
>>> [e.kind for e in tr.events()]
['engine.round', 'plan.stage']
>>> tr.events()[0].attrs["plan"]          # span context stamps its events
'sort'
>>> NULL_TRACER.enabled
False
"""
from __future__ import annotations

import hashlib
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from .metrics import MetricsRegistry

__all__ = ["TraceEvent", "Tracer", "NullTracer", "NULL_TRACER",
           "BatchTracer", "plan_token", "round_event"]

#: attrs inherited from the innermost enclosing span that sets them
_CONTEXT_KEYS = ("plan", "stage", "digest")


def _host_value(v):
    """Coerce an attr to a JSON-able host value: 0-d tensors and arrays
    become Python scalars (a host sync for a tensor on the card), shaped
    ones a ``<array(shape)>`` marker."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    shape = getattr(v, "shape", None)
    if shape is not None:
        if tuple(shape) == ():
            return v.item()
        return f"<array{tuple(shape)}>"
    return str(v)


class TraceEvent:
    """One recorded observation: a kind, a timestamp, an optional duration,
    and a flat string-keyed attribute dict (host scalars only).

    ``dur`` is None for instant events and the span's seconds (in the
    tracer's clock) for span records; ``ts`` is the event (or span-start)
    time.  :meth:`signature` is the time-free identity used by determinism
    tests: two traces of the same seeded run have equal signature
    sequences even though their timestamps differ."""

    __slots__ = ("kind", "ts", "dur", "attrs")

    def __init__(self, kind: str, ts: float, dur: Optional[float] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.kind = kind
        self.ts = float(ts)
        self.dur = None if dur is None else float(dur)
        self.attrs = {} if attrs is None else attrs

    def signature(self) -> Tuple:
        """(kind, sorted attrs) — everything except wall-clock fields."""
        return (self.kind, tuple(sorted(self.attrs.items())))

    def to_dict(self) -> Dict[str, Any]:
        d = {"kind": self.kind, "ts": self.ts}
        if self.dur is not None:
            d["dur"] = self.dur
        d["attrs"] = self.attrs
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TraceEvent":
        return cls(d["kind"], d["ts"], d.get("dur"), dict(d.get("attrs", {})))

    def __repr__(self) -> str:
        dur = "" if self.dur is None else f", dur={self.dur:.6f}"
        return f"TraceEvent({self.kind!r}, ts={self.ts:.6f}{dur}, {self.attrs})"


class _Span:
    """Context manager recording a span event at exit; supports
    ``sp["key"] = value`` to attach attrs discovered mid-span."""

    __slots__ = ("_tracer", "kind", "attrs", "_t0")

    def __init__(self, tracer: "Tracer", kind: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.kind = kind
        self.attrs = attrs
        self._t0 = 0.0

    def __setitem__(self, key: str, value) -> None:
        self.attrs[key] = value

    def __enter__(self) -> "_Span":
        self._tracer._stack.append(self.attrs)
        self._t0 = self._tracer.clock()
        return self

    def __exit__(self, exc_type=None, *exc) -> None:
        tr = self._tracer
        tr._stack.pop()
        if exc_type is not None:
            # A span aborted by an exception (an injected ShardFailure) is
            # marked rather than dropped: aggregation must not read its
            # missing measured fields as a schedule violation.
            self.attrs["aborted"] = True
        tr._record(self.kind, dur=tr.clock() - self._t0, attrs=self.attrs,
                   ts=self._t0)


class _NullSpan:
    """Shared no-op span of :class:`NullTracer`."""

    __slots__ = ()

    def __setitem__(self, key, value) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Tracer:
    """Bounded ring buffer of :class:`TraceEvent` plus a
    :class:`~repro_torch.obs.metrics.MetricsRegistry`.

    - ``maxlen`` bounds the ring: old events are overwritten, never grown —
      :attr:`overwritten` counts the loss, so exporters can say when a
      trace is truncated.
    - ``clock`` is the injectable time source (``time.perf_counter`` by
      default; a :class:`repro_torch.serve.VirtualClock` makes every
      timestamp deterministic under test).
    - :meth:`span` opens a context: events recorded inside inherit the
      span's ``plan``/``stage``/``digest`` attrs, and the span itself is
      recorded at exit with its duration.
    """

    enabled = True

    def __init__(self, maxlen: int = 65536,
                 clock: Callable[[], float] = time.perf_counter):
        if int(maxlen) < 1:
            raise ValueError(f"maxlen must be >= 1, got {maxlen}")
        self.maxlen = int(maxlen)
        self.clock = clock
        self.metrics = MetricsRegistry()
        self._buf: "deque[TraceEvent]" = deque(maxlen=self.maxlen)
        self._stack: List[Dict[str, Any]] = []
        self.recorded = 0           # total records, including overwritten

    # -- recording -----------------------------------------------------------
    def event(self, kind: str, _dur: Optional[float] = None,
              **attrs) -> None:
        """Record an instant event (``_dur`` attaches a measured
        duration)."""
        self._record(kind, dur=_dur, attrs=attrs)

    def trace_event(self, kind: str, **attrs) -> None:
        """Record a decision event (the kernel-vs-dense route).  The JAX
        package records these even while jax traces; eagerly the two
        methods are one."""
        self._record(kind, dur=None, attrs=attrs)

    def span(self, kind: str, **attrs) -> _Span:
        """Open a span context (recorded at exit with its duration)."""
        return _Span(self, kind, attrs)

    def count(self, name: str, n: int = 1) -> None:
        """Increment a metrics counter."""
        self.metrics.counter(name).inc(n)

    def observe(self, name: str, value: float) -> None:
        """Record a histogram observation."""
        self.metrics.histogram(name).observe(value)

    def _record(self, kind: str, dur: Optional[float],
                attrs: Dict[str, Any], ts: Optional[float] = None) -> None:
        clean = {k: _host_value(v) for k, v in attrs.items()}
        for frame in reversed(self._stack):
            for key in _CONTEXT_KEYS:
                if key not in clean and key in frame:
                    clean[key] = frame[key]
        self._buf.append(TraceEvent(
            kind, self.clock() if ts is None else ts, dur, clean))
        self.recorded += 1

    # -- introspection -------------------------------------------------------
    @property
    def overwritten(self) -> int:
        """Events lost to the ring bound (recorded minus retained)."""
        return max(0, self.recorded - len(self._buf))

    def events(self) -> List[TraceEvent]:
        """Snapshot of the retained events, oldest first."""
        return list(self._buf)

    def signatures(self) -> List[Tuple]:
        """Time-free identities of the retained events (determinism
        tests compare these across replays and against the JAX package)."""
        return [e.signature() for e in self._buf]

    def clear(self) -> None:
        """Drop retained events and reset the loss counter (metrics
        keep)."""
        self._buf.clear()
        self.recorded = 0

    def __len__(self) -> int:
        return len(self._buf)


class NullTracer:
    """The default hook: every recording method is a no-op and ``enabled``
    is False, so instrumented call sites guard with one attribute read —
    no work and no host sync on the hot path.  ``metrics`` is a shared
    inert registry (guarded call sites never write it)."""

    enabled = False
    metrics = MetricsRegistry()

    def event(self, kind: str, _dur=None, **attrs) -> None:
        pass

    def trace_event(self, kind: str, **attrs) -> None:
        pass

    def span(self, kind: str, **attrs) -> _NullSpan:
        return _NULL_SPAN

    def count(self, name: str, n: int = 1) -> None:
        pass

    def observe(self, name: str, value: float) -> None:
        pass

    def events(self) -> list:
        return []

    def signatures(self) -> list:
        return []

    def clear(self) -> None:
        pass

    def __len__(self) -> int:
        return 0

    @property
    def overwritten(self) -> int:
        return 0

    @property
    def clock(self) -> Callable[[], float]:
        return time.perf_counter


#: process-wide shared no-op tracer — the default value of every hook slot
NULL_TRACER = NullTracer()


class BatchTracer(NullTracer):
    """What a live tracer records while a batched round program runs
    (``Executable.batch`` on a batchable engine): the route decisions
    (:meth:`trace_event` and ``metrics``) reach ``tracer``, and the
    per-query records (events, spans, counters) drop.  The JAX package's
    batch is one ``jax.jit`` of a ``vmap``, so its tracer drops the same
    records while jax traces.  The port runs every call, so it records one
    ``shuffle.route`` event per batched shuffle on every call, where the
    JAX package records them at the first call of a batch size only."""

    enabled = True
    #: tells the plan interpreter not to open per-stage spans
    batch = True

    def __init__(self, tracer: Tracer):
        self.tracer = tracer
        self.metrics = tracer.metrics

    def trace_event(self, kind: str, **attrs) -> None:
        self.tracer.trace_event(kind, **attrs)

    @property
    def clock(self) -> Callable[[], float]:
        return self.tracer.clock


def plan_token(plan) -> str:
    """Stable short digest of ``(plan.fingerprint, plan.shape_fingerprint)``
    — the same token :func:`repro_torch.core.recovery.plan_digest` keys
    checkpoint directories by, and equal to the JAX package's for the same
    plan parameters."""
    token = repr((plan.fingerprint, plan.shape_fingerprint))
    return hashlib.sha1(token.encode("utf-8")).hexdigest()[:16]


def round_event(tr, t0: float, backend: str, round_idx, n_nodes, capacity,
                stats) -> None:
    """Record one ``engine.round`` event from a round's ``RoundStats``
    (shared by ``MREngine.run_round`` and the plan entry stage).  Reading
    the stats is a host sync on the card — the documented cost of opting
    into per-round tracing; with :data:`NULL_TRACER` this is never
    called."""
    tr.event("engine.round", _dur=tr.clock() - t0, backend=backend,
             round=round_idx, n_nodes=n_nodes, capacity=capacity,
             items_sent=stats.items_sent, max_sent=stats.max_sent,
             max_received=stats.max_received, dropped=stats.dropped)
    tr.count("engine.rounds")

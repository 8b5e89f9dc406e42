"""The tracer hook the engines call: a no-op :class:`NullTracer` default.

Engines guard every recording call with ``tracer.enabled``, so the default
costs one attribute read per hook.  A recording tracer is not ported yet.
"""
from __future__ import annotations

import time

__all__ = ["NullTracer", "NULL_TRACER", "round_event"]


class _NullSpan:
    def __enter__(self):
        return {}

    def __exit__(self, *exc):
        return False


class NullTracer:
    """Every recording method is a no-op and ``enabled`` is False."""

    enabled = False
    clock = staticmethod(time.perf_counter)

    def event(self, kind: str, _dur=None, **attrs) -> None:
        pass

    def trace_event(self, kind: str, **attrs) -> None:
        pass

    def span(self, kind: str, **attrs) -> _NullSpan:
        return _NullSpan()

    def count(self, name: str, n: int = 1) -> None:
        pass


NULL_TRACER = NullTracer()


def round_event(tr, t0: float, backend: str, round_idx, n_nodes, capacity,
                stats) -> None:
    """Record one ``engine.round`` event from a round's RoundStats."""
    tr.event("engine.round", _dur=tr.clock() - t0, backend=backend,
             round=round_idx, n_nodes=n_nodes, capacity=capacity,
             items_sent=stats.items_sent, max_sent=stats.max_sent,
             max_received=stats.max_received, dropped=stats.dropped)
    tr.count("engine.rounds")

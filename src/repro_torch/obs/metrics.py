"""Named counters, gauges, and histograms with a stable snapshot schema.

The aggregation half of ``repro_torch.obs``: where the trace ring buffer
answers "what happened, in order", the registry answers "how much, in
total" — cheap enough to leave on for a whole serving run, and with a
snapshot schema equal to the JAX package's ``repro.obs.metrics``, so the
two packages' snapshots of the same activity compare equal.  numpy only.

>>> reg = MetricsRegistry()
>>> reg.counter("serve.dispatches").inc()
>>> reg.gauge("serve.pending").set(3)
>>> for v in (1.0, 2.0, 3.0, 4.0):
...     reg.histogram("serve.wait_ms").observe(v)
>>> snap = reg.snapshot()
>>> snap["counters"]["serve.dispatches"]
1
>>> snap["gauges"]["serve.pending"]
3.0
>>> snap["histograms"]["serve.wait_ms"]["count"]
4
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict, Optional

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


class Counter:
    """Monotonic integer count."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counters only go up (n={n})")
        self.value += int(n)


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Streaming summary: exact count/total/min/max plus percentiles over
    a bounded window of the most recent ``window`` observations (so a
    long-lived registry never grows unboundedly; p50/p99 become windowed
    estimates once the window wraps)."""

    __slots__ = ("count", "total", "min", "max", "_window")

    def __init__(self, window: int = 4096) -> None:
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._window: "deque[float]" = deque(maxlen=int(window))

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        self._window.append(v)

    def percentile(self, q: float) -> Optional[float]:
        if not self._window:
            return None
        return float(np.percentile(np.asarray(self._window, np.float64), q))

    def summary(self) -> Dict[str, Any]:
        mean = self.total / self.count if self.count else None
        return {"count": self.count, "total": self.total,
                "min": self.min, "max": self.max, "mean": mean,
                "p50": self.percentile(50), "p99": self.percentile(99)}


class MetricsRegistry:
    """Get-or-create registry of named instruments.

    ``snapshot()`` returns the stable JSON-able schema::

        {"counters":   {name: int},
         "gauges":     {name: float},
         "histograms": {name: {count,total,min,max,mean,p50,p99}}}

    Names are sorted in the snapshot, so equal activity yields equal
    snapshots — the determinism the bench gate and the loadgen queueing
    series rely on."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str, window: int = 4096) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(window)
        return h

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        return {
            "counters": {k: self._counters[k].value
                         for k in sorted(self._counters)},
            "gauges": {k: self._gauges[k].value
                       for k in sorted(self._gauges)},
            "histograms": {k: self._histograms[k].summary()
                           for k in sorted(self._histograms)},
        }

    def clear(self) -> None:
        self._counters.clear()
        self._gauges.clear()
        self._histograms.clear()

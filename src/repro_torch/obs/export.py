"""Trace exporters: JSON-lines for tooling, Chrome-trace for timelines.

Two on-disk formats for one event stream, the same as the JAX package's
``repro.obs.export`` writes:

- **JSON-lines** (``write_jsonl`` / ``read_jsonl``): one
  :class:`~repro_torch.obs.trace.TraceEvent` dict per line — the lossless,
  grep-able interchange format.
- **Chrome trace event format** (``to_chrome_trace`` /
  ``write_chrome_trace``): the ``{"traceEvents": [...]}`` JSON that
  ``chrome://tracing`` and https://ui.perfetto.dev load directly.  Spans
  (events with a duration) become complete ``"X"`` slices; instants become
  ``"i"`` marks; each event-kind category (the prefix before the first
  ``.`` — ``engine``, ``plan``, ``serve``, ``fault``, ...) renders as its
  own named thread row.

Timestamps convert from the tracer's clock seconds to the format's
microseconds; a trace recorded on a :class:`repro_torch.serve.VirtualClock`
therefore renders with exact virtual timings.

>>> from repro_torch.obs import Tracer
>>> tr = Tracer(clock=iter(range(10)).__next__)
>>> with tr.span("plan.stage", plan="sort", stage="entry"):
...     tr.event("engine.round", round=0)
>>> doc = to_chrome_trace(tr)
>>> [(r["ph"], r["name"]) for r in doc["traceEvents"]]
[('M', 'thread_name'), ('M', 'thread_name'), ('i', 'engine.round'), ('X', 'plan.stage')]
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, List, Union

from .trace import TraceEvent

__all__ = ["write_jsonl", "read_jsonl", "to_chrome_trace",
           "write_chrome_trace"]

_Path = Union[str, pathlib.Path]


def _events_of(events) -> List[TraceEvent]:
    """Accept a Tracer or an iterable of events."""
    if hasattr(events, "events"):
        events = events.events()
    return list(events)


def write_jsonl(events, path: _Path) -> int:
    """Write one JSON object per event; returns the number written."""
    evs = _events_of(events)
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with p.open("w") as f:
        for e in evs:
            f.write(json.dumps(e.to_dict(), sort_keys=True))
            f.write("\n")
    return len(evs)


def read_jsonl(path: _Path) -> List[TraceEvent]:
    """Load a JSON-lines trace back into :class:`TraceEvent` objects."""
    out = []
    with pathlib.Path(path).open() as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(TraceEvent.from_dict(json.loads(line)))
    return out


def _category(kind: str) -> str:
    return kind.split(".", 1)[0]


def to_chrome_trace(events, pid: int = 0) -> Dict[str, Any]:
    """Render events as a Chrome-trace dict (perfetto-loadable).

    Deterministic: thread ids are assigned to categories in sorted order
    and events keep their recorded order, so equal traces serialize to
    equal JSON."""
    evs = _events_of(events)
    cats = sorted({_category(e.kind) for e in evs})
    tid_of = {c: i for i, c in enumerate(cats)}
    out: List[Dict[str, Any]] = []
    for c in cats:
        out.append({"ph": "M", "pid": pid, "tid": tid_of[c],
                    "name": "thread_name", "args": {"name": c}})
    for e in evs:
        row: Dict[str, Any] = {
            "name": e.kind, "cat": _category(e.kind), "pid": pid,
            "tid": tid_of[_category(e.kind)],
            "ts": e.ts * 1e6, "args": dict(e.attrs),
        }
        if e.dur is not None:
            row["ph"] = "X"
            row["dur"] = e.dur * 1e6
        else:
            row["ph"] = "i"
            row["s"] = "t"
        out.append(row)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(events, path: _Path, pid: int = 0) -> int:
    """Write the Chrome-trace JSON file; returns the number of trace
    events (excluding thread-name metadata)."""
    doc = to_chrome_trace(events, pid=pid)
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(doc))
    return sum(1 for r in doc["traceEvents"] if r["ph"] != "M")

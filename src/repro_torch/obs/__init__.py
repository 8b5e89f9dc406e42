"""repro_torch.obs — round-level observability, the port of ``repro.obs``.

An injectable :class:`Tracer` records typed span/event records (plan
digest, stage, round index, backend, declared vs measured (V_r, M_r),
shuffle stats, kernel-vs-dense route, plan-cache events, serve dispatch
lifecycle, fault/checkpoint/restore events) into a bounded ring buffer next
to a :class:`MetricsRegistry` of named counters, gauges and histograms.
The default hook everywhere is :data:`NULL_TRACER`; every call site guards
with ``tracer.enabled``, so an untraced run does no tracing work and no
host sync, and a traced run's outputs and cost accounting equal the
untraced run's bit for bit.

Exporters render a trace as JSON-lines or a perfetto-loadable Chrome
trace; :func:`summarize` folds it into the per-stage round/bytes/latency
table.
"""
from .trace import (NULL_TRACER, BatchTracer, NullTracer, TraceEvent, Tracer,
                    plan_token, round_event)
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .export import (read_jsonl, to_chrome_trace, write_chrome_trace,
                     write_jsonl)
from .summary import diff_summaries, format_diff, format_table, summarize

__all__ = [
    # trace core
    "TraceEvent", "Tracer", "NullTracer", "NULL_TRACER", "BatchTracer",
    "plan_token", "round_event",
    # metrics registry
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    # exporters
    "write_jsonl", "read_jsonl", "to_chrome_trace", "write_chrome_trace",
    # aggregation
    "summarize", "format_table", "diff_summaries", "format_diff",
]

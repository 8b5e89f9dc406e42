"""Trace aggregation: the per-stage round/bytes/latency table and diffs.

The reading half of ``repro_torch.obs``, the port of the JAX package's
``repro.obs.summary`` (plain Python, the same report):
:func:`summarize` folds one event stream into a JSON-able report whose
core is the **per-stage table** — for every ``(plan, stage)`` observed,
how many times the stage ran, how many rounds it *measured* (the
``CostAccum.rounds`` delta the ``plan.stage`` span recorded) against how
many its schedule *declared* (``PlanStage.rounds`` times the execution
count), plus communication (items sent, drops) and host wall time.
``measured == declared`` is the paper's round-bound schedule checked from
telemetry alone.

:func:`diff_summaries` compares two reports stage by stage (the regression
use: did a change alter round counts, communication, or wall time?).

The report keeps the JAX package's ``pipeline`` section: the
``pipeline.hop`` and ``pipeline.overlap`` events of ``ShardedEngine``'s
overlapped rounds, with the hop and compute seconds of each window's
calibration probe.

The trace → summary flow, end to end:

>>> import torch
>>> from repro_torch.core import LocalEngine, execute_plan, sort_plan
>>> from repro_torch.obs import Tracer, summarize
>>> tracer = Tracer()
>>> engine = LocalEngine(device="cpu", tracer=tracer)
>>> plan = sort_plan(64, 8, align=engine.aligned_nodes)
>>> out = execute_plan(plan, engine, (torch.arange(64.0).flip(0),))
>>> report = summarize(tracer)
>>> report["schedule_ok"]
True
>>> [row["stage"] for row in report["stages"]]
['pivot-sort', 'entry', 'local-sort', 'output']
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

__all__ = ["summarize", "format_table", "diff_summaries", "format_diff"]


def _events_of(events):
    if hasattr(events, "events"):
        events = events.events()
    return list(events)


def _stage_key(attrs: Dict[str, Any]) -> Tuple[str, str]:
    return (str(attrs.get("plan", "?")), str(attrs.get("stage", "?")))


def summarize(events) -> Dict[str, Any]:
    """Fold a trace into the stage/serve/recovery/routing report."""
    evs = _events_of(events)
    stages: "Dict[Tuple[str, str], Dict[str, Any]]" = {}
    order: List[Tuple[str, str]] = []

    def stage_row(key: Tuple[str, str]) -> Dict[str, Any]:
        row = stages.get(key)
        if row is None:
            row = stages[key] = {
                "plan": key[0], "stage": key[1], "executions": 0,
                "measured_rounds": 0, "declared_rounds": 0,
                "shuffle_rounds": 0, "items_sent": 0, "dropped": 0,
                "max_sent": 0, "wall_s": 0.0, "shuffles": True,
            }
            order.append(key)
        return row

    serve = {"submitted": 0, "rejected": 0, "requeued": 0, "failed": 0,
             "completed": 0, "dispatches": 0, "dispatch_errors": 0,
             "deadline_events": 0, "occupancy": 0, "causes": {}}
    recovery = {"failures": 0, "stragglers": 0, "ckpt_saves": 0,
                "ckpt_bytes": 0, "restores": 0, "restarts": 0,
                "aborted_stages": 0}
    routes = {"kernel": 0, "dense": 0}
    pipeline = {"windows": 0, "overlapped_rounds": 0, "hops": 0,
                "wall_s": 0.0, "hop_s": 0.0, "compute_s": 0.0}
    plans: Dict[str, Dict[str, Any]] = {}
    cache = {"hits": 0, "misses": 0, "compiles": 0, "exe_calls": 0}

    for e in evs:
        a = e.attrs
        if e.kind == "plan.stage":
            if a.get("aborted"):
                # Stage killed mid-apply by an injected fault: its replay
                # produces the real row; counting the abort would read as a
                # schedule violation.
                recovery["aborted_stages"] += 1
                continue
            row = stage_row(_stage_key(a))
            row["executions"] += 1
            row["declared_rounds"] += int(a.get("rounds", 0) or 0)
            row["measured_rounds"] += int(a.get("measured_rounds", 0) or 0)
            row["items_sent"] += int(a.get("items_sent", 0) or 0)
            row["dropped"] += int(a.get("dropped", 0) or 0)
            row["shuffles"] = bool(a.get("shuffles", True))
            if e.dur is not None:
                row["wall_s"] += e.dur
        elif e.kind == "engine.round":
            row = stage_row(_stage_key(a))
            row["shuffle_rounds"] += 1
            row["max_sent"] = max(row["max_sent"],
                                  int(a.get("max_sent", 0) or 0))
        elif e.kind == "plan.execute":
            p = plans.setdefault(str(a.get("plan", "?")),
                                 {"executions": 0, "wall_s": 0.0})
            p["executions"] += 1
            if e.dur is not None:
                p["wall_s"] += e.dur
        elif e.kind == "exe.call":
            cache["exe_calls"] += 1
        elif e.kind == "exe.compile":
            cache["compiles"] += 1
        elif e.kind == "cache.hit":
            cache["hits"] += 1
        elif e.kind == "cache.miss":
            cache["misses"] += 1
        elif e.kind == "shuffle.route":
            impl = str(a.get("impl", "?"))
            routes[impl] = routes.get(impl, 0) + 1
        elif e.kind == "pipeline.hop":
            pipeline["hops"] += 1
        elif e.kind == "pipeline.overlap":
            n = int(a.get("rounds", 0) or 0)
            pipeline["windows"] += 1
            pipeline["overlapped_rounds"] += n
            if e.dur is not None:
                pipeline["wall_s"] += e.dur
            # Calibrated un-overlapped per-phase costs, scaled to the
            # window: what the same rounds would cost strictly in sequence.
            pipeline["hop_s"] += float(a.get("hop_s", 0.0) or 0.0) * n
            pipeline["compute_s"] += float(a.get("compute_s", 0.0) or 0.0) * n
        elif e.kind == "serve.submit":
            serve["submitted"] += 1
        elif e.kind == "serve.reject":
            serve["rejected"] += 1
        elif e.kind == "serve.requeue":
            serve["requeued"] += int(a.get("count", 1) or 1)
        elif e.kind == "serve.fail":
            serve["failed"] += 1
        elif e.kind == "serve.dispatch":
            serve["dispatches"] += 1
            k = int(a.get("occupancy", 0) or 0)
            serve["occupancy"] += k
            serve["completed"] += k
            cause = str(a.get("cause", "?"))
            serve["causes"][cause] = serve["causes"].get(cause, 0) + 1
        elif e.kind == "serve.dispatch_error":
            serve["dispatch_errors"] += 1
        elif e.kind == "serve.deadline":
            serve["deadline_events"] += 1
        elif e.kind == "fault.failure":
            recovery["failures"] += 1
        elif e.kind == "fault.straggler":
            recovery["stragglers"] += 1
        elif e.kind == "ckpt.save":
            recovery["ckpt_saves"] += 1
            recovery["ckpt_bytes"] += int(a.get("bytes", 0) or 0)
        elif e.kind == "ckpt.restore":
            recovery["restores"] += 1
        elif e.kind == "recover.restart":
            recovery["restarts"] += 1

    rows = []
    for key in order:
        row = stages[key]
        row["schedule_ok"] = (row["executions"] == 0
                              or row["measured_rounds"]
                              == row["declared_rounds"])
        rows.append(row)
    serve["mean_occupancy"] = (serve["occupancy"] / serve["dispatches"]
                               if serve["dispatches"] else None)
    # Overlap efficiency: the fraction of the calibrated hop cost hidden
    # under compute by the double-buffered schedule — (sequential estimate
    # - measured overlapped wall) / hop cost, clamped to [0, 1].  None when
    # no overlapped window ran (or the probe measured no hop cost).
    if pipeline["windows"] and pipeline["hop_s"] > 0.0:
        seq_est = pipeline["hop_s"] + pipeline["compute_s"]
        hidden = (seq_est - pipeline["wall_s"]) / pipeline["hop_s"]
        pipeline["overlap_efficiency"] = max(0.0, min(1.0, hidden))
    else:
        pipeline["overlap_efficiency"] = None
    return {
        "stages": rows,
        "plans": plans,
        "cache": cache,
        "routes": routes,
        "pipeline": pipeline,
        "serve": serve,
        "recovery": recovery,
        "totals": {
            "events": len(evs),
            "rounds": sum(r["measured_rounds"] for r in rows),
            "items_sent": sum(r["items_sent"] for r in rows),
            "dropped": sum(r["dropped"] for r in rows),
        },
        "schedule_ok": all(r["schedule_ok"] for r in rows),
    }


def format_table(summary: Dict[str, Any]) -> str:
    """Render the per-stage table (plus serve/recovery footers) as text."""
    head = (f"{'plan':<14} {'stage':<18} {'execs':>5} {'rounds':>7} "
            f"{'declared':>8} {'items':>10} {'drops':>6} "
            f"{'wall_ms':>9}  ok")
    lines = [head, "-" * len(head)]
    for r in summary["stages"]:
        lines.append(
            f"{r['plan']:<14} {r['stage']:<18} {r['executions']:>5} "
            f"{r['measured_rounds']:>7} {r['declared_rounds']:>8} "
            f"{r['items_sent']:>10} {r['dropped']:>6} "
            f"{r['wall_s'] * 1e3:>9.2f}  "
            f"{'OK' if r['schedule_ok'] else 'MISMATCH'}")
    t = summary["totals"]
    lines.append(f"total: {t['events']} events, {t['rounds']} rounds, "
                 f"{t['items_sent']} items sent, {t['dropped']} dropped; "
                 f"schedule {'OK' if summary['schedule_ok'] else 'MISMATCH'}")
    srv = summary["serve"]
    if srv["dispatches"]:
        causes = ", ".join(f"{k}={v}" for k, v in sorted(srv["causes"]
                                                         .items()))
        lines.append(
            f"serve: {srv['submitted']} submitted, {srv['dispatches']} "
            f"dispatches (mean occupancy "
            f"{srv['mean_occupancy']:.2f}; {causes}), "
            f"{srv['rejected']} rejected, {srv['requeued']} requeued, "
            f"{srv['failed']} failed")
    rec = summary["recovery"]
    if any(rec.values()):
        lines.append(
            f"recovery: {rec['failures']} failures, {rec['stragglers']} "
            f"stragglers, {rec['restarts']} restarts, {rec['ckpt_saves']} "
            f"checkpoints ({rec['ckpt_bytes']} bytes), "
            f"{rec['restores']} restores")
    routes = summary["routes"]
    if routes.get("kernel", 0) or routes.get("dense", 0):
        lines.append(f"shuffle routes: kernel={routes.get('kernel', 0)} "
                     f"dense={routes.get('dense', 0)}")
    pipe = summary.get("pipeline") or {}
    if pipe.get("windows"):
        eff = pipe.get("overlap_efficiency")
        eff_s = "n/a" if eff is None else f"{eff:.2f}"
        lines.append(
            f"pipeline: {pipe['windows']} overlapped windows "
            f"({pipe['overlapped_rounds']} rounds, {pipe['hops']} hops), "
            f"wall {pipe['wall_s'] * 1e3:.2f} ms vs sequential est. "
            f"{(pipe['hop_s'] + pipe['compute_s']) * 1e3:.2f} ms; "
            f"overlap efficiency {eff_s}")
    return "\n".join(lines)


def diff_summaries(a: Dict[str, Any], b: Dict[str, Any]
                   ) -> List[Dict[str, Any]]:
    """Stage-by-stage comparison of two summaries (``a`` = baseline,
    ``b`` = current).  Returns one row per (plan, stage) present in either,
    with deltas and a ``drift`` flag on any semantic change (rounds, items,
    drops) — wall-time changes are reported but never flagged."""
    rows_a = {(r["plan"], r["stage"]): r for r in a["stages"]}
    rows_b = {(r["plan"], r["stage"]): r for r in b["stages"]}
    keys = list(rows_a)
    keys += [k for k in rows_b if k not in rows_a]
    out = []
    for key in keys:
        ra, rb = rows_a.get(key), rows_b.get(key)
        zero = {"executions": 0, "measured_rounds": 0, "items_sent": 0,
                "dropped": 0, "wall_s": 0.0}
        ra = ra or zero
        rb = rb or zero
        row = {"plan": key[0], "stage": key[1]}
        drift = False
        for field in ("executions", "measured_rounds", "items_sent",
                      "dropped"):
            row[field] = (ra[field], rb[field])
            drift |= ra[field] != rb[field]
        row["wall_s"] = (ra["wall_s"], rb["wall_s"])
        row["drift"] = drift
        out.append(row)
    return out


def format_diff(rows: List[Dict[str, Any]]) -> str:
    """Render a :func:`diff_summaries` result as text."""
    head = (f"{'plan':<14} {'stage':<18} {'rounds a>b':>12} "
            f"{'items a>b':>14} {'drops a>b':>10} {'wall_ms a>b':>16}  flag")
    lines = [head, "-" * len(head)]
    for r in rows:
        ra, rb = r["measured_rounds"]
        ia, ib = r["items_sent"]
        da, db = r["dropped"]
        wa, wb = r["wall_s"]
        lines.append(
            f"{r['plan']:<14} {r['stage']:<18} {ra:>5}>{rb:<5} "
            f"{ia:>6}>{ib:<6} {da:>4}>{db:<4} "
            f"{wa * 1e3:>7.2f}>{wb * 1e3:<7.2f}  "
            f"{'DRIFT' if r['drift'] else 'ok'}")
    n_drift = sum(1 for r in rows if r["drift"])
    lines.append(f"{len(rows)} stages compared, {n_drift} drifted")
    return "\n".join(lines)

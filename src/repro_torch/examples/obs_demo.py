"""Observability demo: one traced serve-with-faults run, end to end.

  python -m repro_torch.examples.obs_demo [--device cpu] [--out DIR]
  python -m repro_torch.tools.trace_summary DIR/trace.jsonl

The port of the JAX package's ``examples/obs_demo.py``.  A seeded mixed
workload (sort / multisearch / hull2d / lp, from the
``repro_torch.serve.loadgen`` suite) arrives Poisson-open-loop at a
``QueryService`` whose dense ``LocalEngine`` has deterministic shard
failures injected — all of it recorded by one ``repro_torch.obs.Tracer``
on the same virtual clock.  The run demonstrates the three obs contracts:

- **neutrality** — the traced run's per-query outputs are bit-identical to
  an untraced replay of the same workload (asserted below);
- **schedule** — the per-stage *measured* round counts in the trace equal
  every plan's declared round-bound schedule (the ``OK`` column of the
  printed table, re-checkable offline with ``repro_torch.tools.
  trace_summary``);
- **timeline** — the trace exports as JSON-lines plus a perfetto-loadable
  Chrome trace (open ``trace.perfetto.json`` at https://ui.perfetto.dev).
"""
import pathlib
import tempfile

from repro_torch.core import LocalEngine
from repro_torch.core.recovery import FaultConfig, with_faults
from repro_torch.obs import (Tracer, format_table, summarize,
                             write_chrome_trace, write_jsonl)
from repro_torch.serve import QueryService, VirtualClock
from repro_torch.serve.loadgen import (TrafficConfig, assert_results_equal,
                                       make_suite, make_workload,
                                       run_open_loop)

from ._common import parser

CFG = TrafficConfig(n_queries=48, seed=7)
FAULTS = dict(fail_at=(3, 11), seed=7)


def serve_run(dev, traced: bool):
    """One seeded serve run on ``dev`` (identical traffic, faults, clock);
    returns (uid -> result, tracer or None, open-loop row).  The tracer
    shares the service's virtual clock, so every timestamp in the trace is
    exact."""
    clock = VirtualClock()
    tracer = Tracer(clock=clock) if traced else None
    engine = with_faults(LocalEngine(device=dev, tracer=tracer),
                         FaultConfig(**FAULTS))
    svc = QueryService(engine, max_batch=4, max_wait_ms=5.0,
                       max_retries=2, clock=clock)
    suite = make_suite(engine, CFG)
    workload = make_workload(suite, CFG)
    svc.register(suite["sort"][0], max_wait_ms=2.0)   # latency-tier override
    row = run_open_loop(svc, workload, offered_qps=800.0, clock=clock,
                        process="poisson", seed=CFG.seed)
    results = {t.uid: t.value for t in svc.finished if not t.failed}
    return results, tracer, row


def run(dev, out: pathlib.Path) -> dict:
    """The traced and the untraced run on ``dev``, the trace written to
    ``out``; prints the row and the stage table, asserts neutrality, the
    schedule and both failures, and returns the row, the summary and the
    files written."""
    traced, tracer, row = serve_run(dev, True)
    plain, _, _ = serve_run(dev, False)
    assert_results_equal(traced, plain, "tracing on vs off")
    print(f"neutrality: {len(traced)} queries bit-identical with and "
          f"without tracing")
    print(f"open loop (poisson): accepted={row['accepted']} "
          f"rejected={row['rejected']} p50_wait={row['p50_wait_ms']:.2f}ms "
          f"mean_occupancy={row['mean_occupancy']:.2f}")

    jsonl, chrome = out / "trace.jsonl", out / "trace.perfetto.json"
    n = write_jsonl(tracer, jsonl)
    write_chrome_trace(tracer, chrome)
    print(f"wrote {n} events -> {jsonl} and {chrome.name}")

    summary = summarize(tracer)
    print(format_table(summary))
    assert summary["schedule_ok"], "measured rounds != declared schedule"
    assert summary["recovery"]["failures"] == len(FAULTS["fail_at"])
    print("schedule: measured == declared for every stage")
    return {"row": row, "summary": summary, "events": n, "jsonl": jsonl,
            "chrome": chrome, "queries": len(traced)}


def main(argv=None) -> None:
    ap = parser(__doc__)
    ap.add_argument("--out", default=str(pathlib.Path(tempfile.gettempdir())
                                         / "repro_torch_obs"),
                    help="directory for trace.jsonl / trace.perfetto.json "
                         "(default: repro_torch_obs in the temp directory)")
    args = ap.parse_args(argv)
    run(args.device, pathlib.Path(args.out))


if __name__ == "__main__":
    main()

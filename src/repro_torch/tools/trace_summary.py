"""Per-stage round/bytes/latency table from a JSON-lines trace — and diffs.

The reading end of :mod:`repro_torch.obs`, the counterpart of the JAX
package's ``tools/trace_summary.py``.  A trace written by
``repro_torch.obs.write_jsonl`` (e.g. by ``python -m
repro_torch.examples.obs_demo``) folds into the stage table whose
``rounds`` column is the *measured* CostAccum delta and whose ``declared``
column is the plan's round-bound schedule — equal rows print ``OK``, so the
paper's round bounds are checkable from telemetry alone.  Traces of a
ShardedEngine overlapped run also print a ``pipeline:`` footer with the
overlap-efficiency figure.  With ``--diff`` two traces are compared stage
by stage and semantic drift (round counts, communication, drops — never
wall time) is flagged.

Usage::

    python -m repro_torch.tools.trace_summary TRACE.jsonl            # table
    python -m repro_torch.tools.trace_summary TRACE.jsonl --json     # JSON
    python -m repro_torch.tools.trace_summary A.jsonl --diff B.jsonl # A = baseline

Exit codes: 0, or 1 when a stage's measured rounds differ from its
declared schedule (or, with ``--diff``, when the traces drift); 0 on a
closed pipe (``... | head``).
"""
import argparse
import json
import os
import sys

from repro_torch.obs import (diff_summaries, format_diff, format_table,
                             read_jsonl, summarize)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="JSON-lines trace file (write_jsonl)")
    ap.add_argument("--diff", metavar="OTHER",
                    help="second trace to compare against (trace = baseline)")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary (or diff rows) as JSON")
    args = ap.parse_args(argv)

    summary = summarize(read_jsonl(args.trace))
    if args.diff:
        rows = diff_summaries(summary, summarize(read_jsonl(args.diff)))
        if args.json:
            print(json.dumps(rows, indent=2, sort_keys=True))
        else:
            print(format_diff(rows))
        return 1 if any(r["drift"] for r in rows) else 0

    if args.json:
        print(json.dumps(summary, indent=2, sort_keys=True))
    else:
        print(format_table(summary))
    return 0 if summary["schedule_ok"] else 1


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:      # e.g. `... trace_summary T.jsonl | head`
        # what is left in stdout's buffer would fail again at exit: send it
        # nowhere
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)

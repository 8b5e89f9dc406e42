"""Query-serving demo: continuous batching over the plan cache.

  python -m repro_torch.examples.serve_queries [--device cpu]

The port of the JAX package's ``examples/serve_queries.py``.  It drives
mixed sort/multisearch traffic through a warmed ``QueryService`` on a dense
``LocalEngine`` and shows the three contracts: window-full and deadline
dispatch, coalesced results bit-identical to sequential calls, and
``QueueFull`` backpressure with a retry-after hint.  The sorts' draws are
int seeds here; :func:`run` takes them, so a test can hand it the JAX
package's draws.
"""
import numpy as np
import torch

from repro_torch.core import LocalEngine, multisearch_plan, sort_plan
from repro_torch.serve import QueryService, QueueFull, VirtualClock

from ._common import parser


def run(dev, keys=(0, 1, 2, 3), search_key=None) -> dict:
    """The demo on ``dev``; ``keys`` are the four sorts' draws and
    ``search_key`` the multisearch's (None: the plan's default seed).
    Prints and returns what it shows."""
    engine = LocalEngine(device=dev)
    clock = VirtualClock()
    svc = QueryService(engine, max_batch=4, max_wait_ms=5.0,
                       max_pending=4, clock=clock)
    rng = np.random.default_rng(0)
    p_sort = sort_plan(64, 16, align=engine.aligned_nodes)
    p_search = multisearch_plan(32, 8, 8, align=engine.aligned_nodes)
    svc.warmup([p_sort, p_search])
    out = {}

    # Four sorts fill the window -> one coalesced dispatch inside submit.
    xs = [torch.from_numpy(rng.normal(size=64).astype(np.float32)).to(dev)
          for _ in range(4)]
    tickets = [svc.submit(p_sort, x, key=k) for x, k in zip(xs, keys)]
    out["window_occupancy"] = tickets[0].batch_occupancy
    out["all_done"] = all(t.done for t in tickets)
    out["sorts"] = [t.value.values for t in tickets]
    print(f"window-full dispatch: occupancy={out['window_occupancy']}, "
          f"all done={out['all_done']}")

    # Coalesced output == sequential output, bit for bit.
    seq = engine.compile(p_sort)(xs[0], key=keys[0])
    out["bit_identical"] = torch.equal(tickets[0].value.values, seq.values)
    print(f"bit-identical to sequential: {out['bit_identical']}")

    # A lone multisearch waits for the 5 ms deadline sweep instead.
    q = torch.from_numpy(rng.normal(size=32).astype(np.float32)).to(dev)
    piv = torch.sort(torch.from_numpy(
        rng.normal(size=8).astype(np.float32)).to(dev)).values
    t = svc.submit(p_search, q, piv, key=search_key)
    clock.advance(0.005)
    svc.step()
    out["deadline_occupancy"] = t.batch_occupancy
    out["deadline_latency_ms"] = t.latency * 1e3
    out["buckets"] = t.value.buckets
    print(f"deadline dispatch: occupancy={t.batch_occupancy}, "
          f"latency={out['deadline_latency_ms']:.1f} ms (exact: virtual "
          f"clock)")

    # Overfill the admission window (partial windows on two plans, so
    # nothing auto-dispatches) -> QueueFull with a retry hint.
    out["queue_full"] = None
    try:
        for _ in range(3):
            svc.submit(p_sort, xs[0], key=keys[0])
            svc.submit(p_search, q, piv, key=search_key)
    except QueueFull as e:
        out["queue_full"] = e.reason
        print(f"backpressure: {e} [reason={e.reason}]")
    svc.drain()
    st = svc.stats()
    out["stats"] = st
    print(f"stats: completed={st['completed']} rejected={st['rejected']} "
          f"dispatches={st['dispatches']} "
          f"mean_occupancy={st['mean_occupancy']:.1f} "
          f"traces={st['traces']}")
    return out


def main(argv=None) -> None:
    args = parser(__doc__).parse_args(argv)
    run(args.device)


if __name__ == "__main__":
    main()

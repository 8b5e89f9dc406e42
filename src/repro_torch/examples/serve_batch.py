"""Continuous-batching serving demo (Theorem 4.2 admission control).

  python -m repro_torch.examples.serve_batch [--device cpu]

The port of the JAX package's ``examples/serve_batch.py``.  It submits a
skewed burst of requests (more than the engine's max_batch — the paper's
over-M congestion case) to a ``ServeEngine`` over the reduced TinyLlama,
watches the FIFO queue drain under the bounded-admission discipline, and
prints latency/TTFT statistics.  As in the JAX engine, a prompt is fed one
token a decode step (no separate prefill).
"""
import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeConfig, ServeEngine

from ._common import parser


def requests(vocab_size: int):
    """The burst: 12 requests with skewed prompt lengths and budgets, drawn
    from ``np.random.default_rng(0)`` in the JAX example's order."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(12):
        plen = int(rng.integers(4, 16))
        out.append(Request(
            uid=i, prompt=rng.integers(0, vocab_size, plen).astype(np.int32),
            max_new_tokens=int(rng.integers(8, 24))))
    return out


def run(dev, model=None) -> dict:
    """Drain the burst on ``dev``; ``model`` defaults to the reduced
    TinyLlama drawn from seed 0.  Prints and returns the engine's stats,
    the finish order and each request's tokens."""
    cfg = get_config("tinyllama-1.1b", reduced=True)
    if model is None:
        model = build_model(cfg, device=dev, seed=0)
    eng = ServeEngine(model, ServeConfig(max_batch=4, max_len=96))
    for req in requests(cfg.vocab_size):
        eng.submit(req)
    print("submitted 12 requests against max_batch=4 "
          "(Thm 4.2 FIFO input buffer holds the excess)")
    done = eng.run_until_drained()
    s = eng.stats()
    order = [r.uid for r in sorted(done, key=lambda r: r.finished_at)]
    print(f"drained in {s['rounds']} rounds; {s['tokens']} tokens; "
          f"mean latency {s['mean_latency_s']*1e3:.0f} ms; "
          f"mean TTFT {s['mean_ttft_s']*1e3:.0f} ms")
    print(f"FIFO order preserved: {order[:6]}... "
          f"(first-submitted finish first for equal lengths)")
    assert len(done) == 12
    assert eng.cost.max_reducer_io <= 4      # the M bound held every round
    return {"stats": s, "order": order,
            "max_reducer_io": eng.cost.max_reducer_io,
            "outputs": {r.uid: list(r.output) for r in done}}


def main(argv=None) -> None:
    args = parser(__doc__).parse_args(argv)
    run(args.device)


if __name__ == "__main__":
    main()

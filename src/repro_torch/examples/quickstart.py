"""Quickstart: the paper's algorithms + a tiny model, end to end.

  python -m repro_torch.examples.quickstart [--device cpu]

The port of the JAX package's ``examples/quickstart.py``: the paper's
primitives, one plan on the reference, local and sharded backends,
``exe.batch(8)`` with the plan cache, and the reduced TinyLlama's loss and
gradients (``loss.backward()`` on the module).  Random draws are int seeds
here; each function takes them as arguments, so a test can hand it the JAX
package's own draws (as sample indices or slots) and compare the numbers.
"""
import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import (HardwareModel, LocalEngine, MRCost,
                              ReferenceEngine, ShardedEngine, compile_plan,
                              funnel_write, multisearch, multisearch_plan,
                              prefix_plan, random_indexing, sort_plan)
from repro_torch.models import build_model

from ._common import one_rank_group, parser

M = 64


def paper_primitives(dev, index_key=1, search_key=0, sort_key=None) -> dict:
    """The paper's primitives at M = 64 on ``dev`` (a dense ``LocalEngine``
    for the plans); prints and returns their rounds, communication and
    loads.  ``index_key``, ``search_key`` and ``sort_key`` are the random
    indexing's, the multisearch's and the sort's draws (None: the plan's
    default seed)."""
    print("=== paper primitives (I/O-memory-bound MapReduce, M=64) ===")
    rng = np.random.default_rng(0)
    engine = LocalEngine(device=dev)
    out = {}

    x = torch.from_numpy(rng.integers(0, 10, 5000).astype(np.int32)).to(dev)
    pres = compile_plan(prefix_plan(5000, M, dtype=x.dtype), engine)(x)
    out["prefix"] = (int(pres.stats.rounds), int(pres.stats.communication))
    print(f"prefix sums (Lemma 2.2): n=5000  rounds={out['prefix'][0]}  "
          f"communication={out['prefix'][1]}  "
          f"(paper: O(log_M N), O(N log_M N))")

    c = MRCost()
    random_indexing(5000, index_key, M, cost=c, device=dev)
    out["random_indexing"] = (c.rounds, c.max_reducer_io)
    print(f"random indexing (Lemma 2.3): rounds={c.rounds}  max leaf "
          f"occupancy={c.max_reducer_io} <= M={M}")

    addrs = torch.from_numpy(rng.integers(0, 100, 4096).astype(np.int32)
                             ).to(dev)
    vals = torch.ones(4096, device=dev)
    c = MRCost()
    hist = funnel_write(addrs, vals, torch.zeros(100, device=dev), torch.add,
                        M, cost=c, identity=0.0)
    out["funnel"] = (c.rounds, int(hist.max_fan_in))
    print(f"invisible-funnel Sum-CRCW histogram (Thm 3.2): P=4096 "
          f"rounds={c.rounds}  max fan-in={out['funnel'][1]}")

    q = torch.from_numpy(rng.normal(size=4096).astype(np.float32)).to(dev)
    piv = torch.sort(torch.from_numpy(
        rng.normal(size=512).astype(np.float32)).to(dev)).values
    c = MRCost()
    ms = multisearch(q, piv, M, key=search_key, cost=c)
    out["multisearch"] = (int(ms.rounds), int(ms.max_congestion))
    print(f"multi-search (Thm 4.1): |Q|=4096 |T|=512  rounds="
          f"{out['multisearch'][0]}  max congestion={out['multisearch'][1]}")

    x = torch.from_numpy(rng.normal(size=4096).astype(np.float32)).to(dev)
    c = MRCost()
    res = compile_plan(sort_plan(4096, M), engine)(x, key=sort_key)
    c.absorb(res.stats)
    out["sorted"] = bool((res.values[1:] >= res.values[:-1]).all())
    assert out["sorted"]
    hw = HardwareModel(chips=256)
    out["sort"] = (c.rounds, c.communication)
    out["shuffle_time_us"] = hw.shuffle_time(c) * 1e6
    print(f"sample sort (§4.3): n=4096  rounds={c.rounds}  "
          f"communication={c.communication}")
    print(f"  cost-model wall time on 256 H100s, computed from the port's "
          f"H100 figures (T = t + R*L + C/B): {out['shuffle_time_us']:.1f} us")
    return out


def engine_backends(dev, key=0, batch_keys=None, search_key=None) -> dict:
    """One sort plan on the reference, local and sharded backends (the
    sharded one over the caller's process group, or a one-rank group of
    this process), ``exe.batch(8)`` and the plan cache, and a multisearch
    plan; prints and returns each one's numbers.  ``key`` is the sort's
    draw, ``batch_keys`` the batch's eight and ``search_key`` the
    multisearch's (None: the plan's default seeds)."""
    print("\n=== plan/compile/execute: one plan, three backends ===")
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=4096).astype(np.float32))
    out = {"backends": {}}
    with one_rank_group(dev):
        engines = (ReferenceEngine(), LocalEngine(device=dev),
                   ShardedEngine(device=dev))
        for engine in engines:
            # the reference backend computes on the host
            data = x if engine.name == "reference" else x.to(dev)
            plan = sort_plan(4096, M, align=engine.aligned_nodes)
            res = engine.compile(plan)(data, key=key)
            ok = bool((res.values[1:] >= res.values[:-1]).all())
            row = (int(res.stats.rounds), plan.round_bound,
                   int(res.stats.communication), int(res.stats.dropped), ok)
            out["backends"][engine.name] = row
            print(f"sort_plan[{engine.name:9s}] rounds={row[0]}"
                  f" (bound {row[1]})  comm={row[2]}  dropped={row[3]}  "
                  f"sorted={ok}")
    # compile is cached (same fingerprint -> same executable), and
    # batch(B) runs the B queries as one round program
    engine = LocalEngine(device=dev)
    exe = engine.compile(sort_plan(4096, M))
    assert engine.compile(sort_plan(4096, M)) is exe
    B = 8
    xs = torch.from_numpy(rng.normal(size=(B, 4096)).astype(np.float32)
                          ).to(dev)
    outs = exe.batch(B)(xs, keys=batch_keys)
    ok = bool((outs.values[:, 1:] >= outs.values[:, :-1]).all())
    out["batch"] = ok
    out["cache"] = engine.cache_info()
    print(f"exe.batch({B}): {B} sorts in one round program  sorted={ok}  "
          f"cache={out['cache']}")

    q = torch.from_numpy(rng.normal(size=512).astype(np.float32)).to(dev)
    piv = torch.sort(torch.from_numpy(
        rng.normal(size=64).astype(np.float32)).to(dev)).values
    ms = compile_plan(multisearch_plan(512, 64, 16), engine)(
        q, piv, key=search_key)
    want = np.searchsorted(piv.cpu().numpy(), q.cpu().numpy(), side="left")
    out["multisearch"] = (int(ms.stats.rounds),
                          bool((ms.buckets.cpu().numpy() == want).all()))
    print(f"multisearch_plan[local] rounds={out['multisearch'][0]}  correct="
          f"{out['multisearch'][1]}")
    return out


def tiny_model(dev, model=None) -> dict:
    """The reduced TinyLlama's loss on a (4, 32) batch and the gradients
    of every parameter by ``loss.backward()``; ``model`` defaults to the
    config's model drawn from seed 0 on ``dev``."""
    print("\n=== tiny LM forward/backward on the same substrate ===")
    cfg = get_config("tinyllama-1.1b", reduced=True)
    if model is None:
        model = build_model(cfg, device=dev, seed=0)
    rng = np.random.default_rng(0)
    batch = {
        "tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32))
                                   ).to(dev),
        "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32))
                                   ).to(dev),
    }
    model.zero_grad(set_to_none=True)
    loss, _ = model.loss_fn(batch)
    loss.backward()
    params = list(model.parameters())
    out = {"params": sum(p.numel() for p in params), "loss": loss.item(),
           "finite": all(p.grad is not None and bool(torch.isfinite(
               p.grad).all()) for p in params)}
    print(f"arch={cfg.name} (reduced)  params={out['params']:,}  "
          f"loss={out['loss']:.3f}  grads finite={out['finite']}")
    return out


def main(argv=None) -> None:
    args = parser(__doc__).parse_args(argv)
    dev = args.device
    paper_primitives(dev)
    engine_backends(dev)
    tiny_model(dev)


if __name__ == "__main__":
    main()

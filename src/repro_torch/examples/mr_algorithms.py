"""The paper, end to end: every theorem exercised and its bounds checked.

  python -m repro_torch.examples.mr_algorithms [--device cpu]

The port of the JAX package's ``examples/mr_algorithms.py``.  It walks
through §2-§4 of Goodrich-Sitchinava-Zhang: the generic model, prefix sums,
random indexing, BSP simulation, CRCW PRAM simulation via invisible
funnels, multi-search with pipelined batches, FIFO queues, and sample sort,
then one plan on three backends and the engine-native geometry of §1.4 —
printing measured (rounds, communication) against the paper's O(.) claims.

Each theorem or section is a function that takes its inputs and random
draws and returns the numbers it prints; :func:`inputs` draws the inputs
in the JAX script's order from one numpy generator, so a test can hand the
same inputs and the JAX package's draws to both packages.  Random draws
are int seeds here (the JAX script's ``PRNGKey`` seeds).
"""
import numpy as np
import torch

from repro_torch.core import (BSPProgram, LocalEngine, MRCost, PRAMProgram,
                              ReferenceEngine, ShardedEngine, brute_force_sort,
                              bsp_plan, compile_plan, convex_hull_3d,
                              convex_hull_3d_oracle, convex_hull_oracle,
                              dequeue, enqueue, hull2d_plan, hull3d_round_bound,
                              hull_round_bound, linear_program_nd,
                              linear_program_oracle, log_M, lp_round_bound,
                              make_queues, multisearch, multisearch_plan,
                              prefix_cost_bound, prefix_plan, random_indexing,
                              shuffle, simulate_crcw, sort_plan, tree_height)

from ._common import one_rank_group, parser

M = 32


def inputs(seed: int = 0) -> dict:
    """Every numpy input of the walkthrough, drawn in the JAX script's
    order from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return {
        "dests": rng.integers(0, 64, (64, 4)).astype(np.int32),
        "bsp_vals": rng.normal(size=64).astype(np.float32),
        "crcw_data": rng.integers(0, 16, 2048).astype(np.int32),
        "queries": rng.normal(size=8192).astype(np.float32),
        "pivots": rng.normal(size=1024).astype(np.float32),
        "sort_x": rng.normal(size=20000).astype(np.float32),
        "pts2": rng.normal(size=(3000, 2)).astype(np.float32),
        "pts3": rng.normal(size=(20, 3)).astype(np.float32),
        "A4": rng.normal(size=(12, 4)),
        "b4": rng.uniform(1, 2, 12),
        "c4": rng.normal(size=4),
    }


def generic_shuffle(dev, dests) -> dict:
    """Theorem 2.1: the generic shuffle of 256 items over 64 nodes."""
    payload = torch.arange(256, dtype=torch.float32, device=dev).reshape(64, 4)
    box, stats = shuffle(torch.as_tensor(dests, device=dev), payload, 64, M)
    out = {"delivered": int(box.valid.sum()),
           "max_received": int(stats.max_received),
           "dropped": int(stats.dropped)}
    print(f"[Thm 2.1] shuffle of 256 items over 64 nodes: delivered="
          f"{out['delivered']} max_received={out['max_received']} "
          f"dropped={out['dropped']}")
    return out


def prefix_sums(dev, engine, n: int = 10000) -> dict:
    """Lemma 2.2: prefix sums of n ones against the lemma's bounds."""
    pres = compile_plan(prefix_plan(n, M), engine)(
        torch.ones(n, dtype=torch.int32, device=dev))
    rb, cb = prefix_cost_bound(n, M)
    out = {"rounds": int(pres.stats.rounds), "round_bound": rb,
           "communication": int(pres.stats.communication), "comm_bound": cb,
           "correct": int(pres.values[-1]) == n}
    print(f"[Lem 2.2] prefix sums n={n}: rounds={out['rounds']} "
          f"(bound {rb}), comm={out['communication']} (bound {cb}); "
          f"correct={out['correct']}")
    return out


def random_indexing_lemma(dev, key=0, n: int = 10000) -> dict:
    """Lemma 2.3: random indexing of n items; ``key`` is the draw."""
    c = MRCost()
    idx = random_indexing(n, key, M, cost=c, device=dev)
    out = {"rounds": c.rounds, "max_occupancy": c.max_reducer_io,
           "permutation": sorted(idx.tolist()) == list(range(n)),
           "idx": idx}
    print(f"[Lem 2.3] random indexing: rounds={c.rounds}, max leaf occupancy="
          f"{c.max_reducer_io} (w.h.p. <= M={M}); "
          f"permutation={out['permutation']}")
    return out


def bsp_tree_sum(dev, engine, vals) -> dict:
    """Theorem 3.1: a BSP tree sum of 64 processors in 7 supersteps."""
    P = vals.shape[0]
    vals = torch.as_tensor(vals, device=dev)

    def superstep(t, ids, state, inbox, inbox_valid):
        contrib = torch.where(inbox_valid, inbox, 0.0).sum(1)
        state = state + contrib
        stride = 2 ** t
        sender = (ids % (2 * stride)) == stride
        return (state, torch.where(sender, ids - stride, -1)[:, None]
                .to(torch.int32), state[:, None])

    bres = compile_plan(bsp_plan(BSPProgram(superstep), 7, 8, P,
                                 torch.tensor(0.0)), engine)(vals)
    total = float(bres.proc_state[0])
    out = {"rounds": int(bres.stats.rounds),
           "communication": int(bres.stats.communication), "sum": total,
           "sum_ok": bool(np.isclose(total, float(vals.sum()), rtol=1e-5))}
    print(f"[Thm 3.1] BSP tree-sum of {P} procs: R=7 supersteps -> "
          f"rounds={out['rounds']}, C={out['communication']} = O(R*N); "
          f"sum ok={out['sum_ok']}")
    return out


def crcw_histogram(dev, data, cells: int = 16) -> dict:
    """Theorem 3.2: a Sum-CRCW histogram through the invisible funnels."""
    Pp = data.shape[0]
    data = torch.as_tensor(data, device=dev)
    prog = PRAMProgram(read_addr=lambda s, t: s,
                       compute=lambda s, v, t: (s, s, torch.ones_like(
                           s, dtype=torch.float32)))
    c = MRCost()
    _, hist = simulate_crcw(prog, data, torch.zeros(cells, device=dev), 1,
                            M, torch.add, cost=c, identity=0.0)
    d = max(2, M // 2)
    want = np.bincount(data.cpu().numpy(), minlength=cells)
    out = {"rounds": c.rounds, "bound": 3 * tree_height(Pp, d) + 2,
           "correct": bool(np.allclose(hist.cpu().numpy(), want))}
    print(f"[Thm 3.2] Sum-CRCW histogram, P={Pp}, N={cells}: rounds="
          f"{c.rounds} (O(T log_M P) = {out['bound']}); "
          f"correct={out['correct']}")
    return out


def pipelined_multisearch(dev, queries, pivots, key=0) -> dict:
    """Theorem 4.1: multisearch pipelined in random batches (``key`` the
    batches' draw) against one un-pipelined batch."""
    q = torch.as_tensor(queries, device=dev)
    piv = torch.sort(torch.as_tensor(pivots, device=dev)).values
    c = MRCost()
    res = multisearch(q, piv, M, key=key, cost=c)
    flat = multisearch(q, piv, M, pipelined=False)
    out = {"rounds": int(res.rounds), "congestion": int(res.max_congestion),
           "flat_congestion": int(flat.max_congestion),
           "buckets": res.buckets}
    print(f"[Thm 4.1] multisearch |Q|={q.shape[0]} |T|={piv.shape[0]}: "
          f"rounds={out['rounds']}, congestion={out['congestion']} "
          f"(un-pipelined: {out['flat_congestion']}) — pipelining cuts "
          f"per-node load "
          f"{out['flat_congestion'] / out['congestion']:.1f}x")
    return out


def fifo_queues(dev) -> dict:
    """Theorem 4.2: a 100-item burst at one node drained M at a round."""
    qs = make_queues(8, 256, torch.tensor(0.0), device=dev)
    qs, _ = enqueue(qs, torch.zeros(100, dtype=torch.int32, device=dev),
                    torch.arange(100.0, device=dev))
    served, rounds = [], 0
    while int(qs.size.sum()) > 0:
        qs, got, valid = dequeue(qs, M)
        served.extend(got[0][valid[0]].tolist())
        rounds += 1
    out = {"rounds": rounds, "fifo": served == sorted(served)}
    print(f"[Thm 4.2] 100-item burst at one node, M={M}: drained in {rounds} "
          f"rounds (= ceil(C/M) + O(1)); FIFO preserved={out['fifo']}")
    return out


def sample_sort(dev, engine, x, key=None) -> dict:
    """§4.3: the sample sort of x (``key`` the splitter draw, None the
    plan's default seed), and Lemma 4.3's brute-force sort of its first
    500 keys."""
    x = torch.as_tensor(x, device=dev)
    n = x.shape[0]
    sres = compile_plan(sort_plan(n, M), engine)(x, key=key)
    out = {"rounds": int(sres.stats.rounds),
           "communication": int(sres.stats.communication),
           "bound": n * log_M(n, M),
           "sorted": bool((sres.values[1:] >= sres.values[:-1]).all())}
    print(f"[§4.3] sample sort n={n}: rounds={out['rounds']}, "
          f"comm={out['communication']} (O(N log_M N) = {out['bound']}); "
          f"sorted={out['sorted']}")
    c = MRCost()
    brute_force_sort(x[:500], M, cost=c)
    out["brute_force_communication"] = c.communication
    print(f"[Lem 4.3] brute-force sort n=500: comm={c.communication} "
          f"(O(N^2 log_M N) — why it is only used on the sqrt(N) pivots)")
    return out


def _engines(dev):
    return (ReferenceEngine(), LocalEngine(device=dev),
            ShardedEngine(device=dev))


def three_backends(dev, x, key=1, search_key=None, n: int = 4096,
                   n_queries: int = 2000, n_pivots: int = 128) -> dict:
    """A sort plan over x[:n] on the reference, local and sharded backends
    (``key`` the splitter draw), then a multisearch plan of x[:n_queries]
    over the sorted next n_pivots keys on the local one (``search_key``,
    None the plan's default seed).  The sharded engine runs over the
    caller's process group."""
    print("\nplan/compile/execute (Thm 2.1 as an interface):")
    x = torch.as_tensor(x)
    xs = x[:n]
    want = np.sort(xs.numpy())
    out = {"sort": {}}
    for engine in _engines(dev):
        # the reference backend computes on the host
        data = xs if engine.name == "reference" else xs.to(dev)
        plan = sort_plan(n, M, align=engine.aligned_nodes)
        res = engine.compile(plan)(data, key=key)
        row = (int(res.stats.rounds), int(res.stats.communication),
               int(res.stats.dropped),
               bool((res.values.cpu().numpy() == want).all()))
        out["sort"][engine.name] = row
        print(f"  sort_plan on {engine.name:9s}: rounds={row[0]} "
              f"comm={row[1]} dropped={row[2]} correct={row[3]}")
    qq = x[:n_queries].to(dev)
    pv = torch.sort(x[n_queries:n_queries + n_pivots].to(dev)).values
    bk = compile_plan(multisearch_plan(n_queries, n_pivots, M),
                      LocalEngine(device=dev))(qq, pv, key=search_key)
    want = np.searchsorted(pv.cpu().numpy(), qq.cpu().numpy(), side="left")
    out["multisearch"] = (int(bk.stats.rounds),
                          bool((bk.buckets.cpu().numpy() == want).all()))
    out["buckets"] = bk.buckets
    print(f"  multisearch_plan on local: rounds={out['multisearch'][0]} "
          f"correct={out['multisearch'][1]}")
    return out


def hull2d_backends(dev, pts2, key=2, small_key=None) -> dict:
    """The 2-D hull plan on the reference (first 400 points: it shuffles
    item by item on the host), local and sharded backends against the
    oracle.  ``key`` is the splitter draw, ``small_key`` the reference
    run's (None: ``key``)."""
    print("\nengine-native geometry (repro_torch.core.geometry, §1.4):")
    pts2 = torch.as_tensor(pts2)
    want_full = convex_hull_oracle(pts2.numpy())
    want_small = convex_hull_oracle(pts2[:400].numpy())
    out = {}
    for engine in _engines(dev):
        small = engine.name == "reference"
        sub, want = (pts2[:400], want_small) if small else (pts2.to(dev),
                                                            want_full)
        plan = hull2d_plan(sub.shape[0], M, align=engine.aligned_nodes)
        res = engine.compile(plan)(sub, key=(small_key if small and
                                             small_key is not None else key))
        h = int(res.count)
        row = (sub.shape[0], int(res.stats.rounds),
               hull_round_bound(sub.shape[0], M), h, int(res.stats.dropped),
               bool(h == len(want) and np.allclose(
                   res.points[:h].cpu().numpy(), want, atol=1e-5)))
        out[engine.name] = row
        print(f"  2-D hull on {engine.name:9s}: n={row[0]} rounds={row[1]} "
              f"(O(log_M N) bound {row[2]}) h={row[3]} dropped={row[4]} "
              f"correct={row[5]}")
    return out


def hull3d_crcw(dev, pts3) -> dict:
    """The 3-D hull by the Theorem 3.2 CRCW simulation over C(20, 3) facet
    processors on a dense ``LocalEngine``."""
    c = MRCost()
    verts = convex_hull_3d(pts3, M, engine=LocalEngine(device=dev), cost=c)
    out = {"rounds": c.rounds, "bound": hull3d_round_bound(len(pts3), M),
           "verts": len(verts),
           "correct": bool(np.array_equal(verts,
                                          convex_hull_3d_oracle(pts3)))}
    print(f"  3-D hull via Thm 3.2 CRCW (P=C(20,3) facet procs, "
          f"Max-funnels): rounds={out['rounds']} (O(T log_M P) bound "
          f"{out['bound']}) verts={out['verts']} correct={out['correct']}")
    return out


def lp_min_crcw(dev, c4, A4, b4) -> dict:
    """A d = 4 linear program by Min-CRCW over C(12, 4) bases on a dense
    ``LocalEngine``, against the float64 oracle."""
    c = MRCost()
    _, obj4 = linear_program_nd(c4, A4, b4, M, engine=LocalEngine(device=dev),
                                cost=c)
    _, want4 = linear_program_oracle(c4, A4, b4)
    out = {"rounds": c.rounds, "bound": lp_round_bound(12, 4, M),
           "objective": obj4, "correct": abs(obj4 - want4) < 1e-3}
    print(f"  d=4 LP by Min-CRCW over C(12,4) bases: rounds={c.rounds} "
          f"(O(log_M P) bound {out['bound']}) obj={obj4:.4f} "
          f"correct={out['correct']}")
    return out


def run(dev) -> dict:
    """The whole walkthrough on ``dev`` (the sharded engine over the
    caller's process group, or a one-rank group of this process); returns
    each section's numbers by name."""
    print(f"I/O-memory-bound MapReduce with M = {M}\n")
    x = inputs()
    engine = LocalEngine(device=dev)
    out = {"shuffle": generic_shuffle(dev, x["dests"]),
           "prefix": prefix_sums(dev, engine),
           "random_indexing": random_indexing_lemma(dev),
           "bsp": bsp_tree_sum(dev, engine, x["bsp_vals"]),
           "crcw": crcw_histogram(dev, x["crcw_data"]),
           "multisearch": pipelined_multisearch(dev, x["queries"],
                                                x["pivots"]),
           "queues": fifo_queues(dev),
           "sort": sample_sort(dev, engine, x["sort_x"])}
    with one_rank_group(dev):
        out["backends"] = three_backends(dev, x["sort_x"])
        out["hull2d"] = hull2d_backends(dev, x["pts2"])
    out["hull3d"] = hull3d_crcw(dev, x["pts3"])
    out["lp"] = lp_min_crcw(dev, x["c4"], x["A4"], x["b4"])
    return out


def main(argv=None) -> None:
    args = parser(__doc__).parse_args(argv)
    run(args.device)


if __name__ == "__main__":
    main()

"""The port's examples (``repro_torch.examples``) against the JAX package.

The functions of quickstart, mr_algorithms, serve_queries and serve_batch
run on the CPU, at the JAX examples' sizes or smaller, fed the JAX
package's random draws (as sample indices or slots), and their rounds,
communication, drops and values equal those of the same ``repro.core``
calls.  The JAX example scripts themselves are not run: they take minutes
on the CPU.  (train_lm: ``tests/test_torch_train_lm.py``; obs_demo:
``tests/test_torch_tools.py``; every example's refusal without CUDA:
``tests/test_torch_isolation.py``.)
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.core as J
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serve import QueryService as JQueryService
from repro.serve import QueueFull as JQueueFull
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import VirtualClock as JVirtualClock
from repro_torch.configs import get_config
from repro_torch.core import LocalEngine
from repro_torch.examples import (mr_algorithms, quickstart, serve_batch,
                                  serve_queries)
from repro_torch.examples._common import one_rank_group
from repro_torch.interop import lm_params_from_numpy

CPU = torch.device("cpu")


def _perm(key, n):
    """The sample indices the JAX sort and hull plans draw from ``key``."""
    return np.asarray(jax.random.permutation(key, n))


def _slots(key, n):
    """The slots the JAX random indexing (and multisearch) draws."""
    return np.asarray(jax.random.randint(key, (n,), 0,
                                         min(max(n, 2) ** 3, 2**31 - 1),
                                         dtype=jnp.int32))


def _cost(fn):
    c = J.MRCost()
    out = fn(c)
    return c, out


@pytest.fixture(autouse=True)
def jax_trace_state_clean(monkeypatch):
    """The JAX package's tracer calls ``jax.core.trace_state_clean``, which
    some jax releases keep only as ``jax._src.core.trace_state_clean``."""
    if not hasattr(jax.core, "trace_state_clean"):
        from jax._src import core as jax_src_core
        monkeypatch.setattr(jax.core, "trace_state_clean",
                            jax_src_core.trace_state_clean, raising=False)


# ------------------------------------------------------------ quickstart
def test_quickstart_primitives_match_jax(capsys):
    """``paper_primitives`` against the JAX calls of the JAX quickstart on
    the same numpy draws and the JAX package's keys."""
    got = quickstart.paper_primitives(
        CPU, index_key=_slots(jax.random.PRNGKey(1), 5000),
        search_key=_slots(jax.random.PRNGKey(0), 4096),
        sort_key=_perm(jax.random.PRNGKey(7), 4096))
    assert "paper primitives" in capsys.readouterr().out
    M, rng = 64, np.random.default_rng(0)
    x = jnp.asarray(rng.integers(0, 10, 5000).astype(np.int32))
    pres = J.compile_plan(J.prefix_plan(5000, M, dtype=x.dtype))(x)
    assert got["prefix"] == (int(pres.stats.rounds),
                             int(pres.stats.communication))
    c, _ = _cost(lambda c: J.random_indexing(5000, jax.random.PRNGKey(1), M,
                                             cost=c))
    assert got["random_indexing"] == (c.rounds, c.max_reducer_io)
    addrs = jnp.asarray(rng.integers(0, 100, 4096).astype(np.int32))
    # jitted (eager, the JAX dense funnel compiles op by op): the stats
    # are functional, the cost the same
    hist = jax.jit(lambda a, v, m: J.funnel_write(
        a, v, m, jnp.add, M, identity=jnp.float32(0)))(
            addrs, jnp.ones(4096, jnp.float32), jnp.zeros(100, jnp.float32))
    c = J.MRCost()
    c.absorb(hist.stats)
    assert got["funnel"] == (c.rounds, int(hist.max_fan_in))
    q = jnp.asarray(rng.normal(size=4096).astype(np.float32))
    piv = jnp.sort(jnp.asarray(rng.normal(size=512).astype(np.float32)))
    c, ms = _cost(lambda c: J.multisearch(q, piv, M, cost=c))
    assert got["multisearch"] == (ms.rounds, int(ms.max_congestion))
    x = jnp.asarray(rng.normal(size=4096).astype(np.float32))
    res = J.compile_plan(J.sort_plan(4096, M))(x)
    assert got["sort"] == (int(res.stats.rounds),
                           int(res.stats.communication))
    assert got["sorted"] and got["shuffle_time_us"] > 0


def test_quickstart_backends_match_jax(capsys):
    """The sort on three backends (the JAX local engine's numbers; the JAX
    sharded engine fails on whole plans under this jax), the batch of
    eight on the JAX keys, the cache, and the multisearch plan."""
    key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, 8)
    default = jax.random.PRNGKey(7)
    got = quickstart.engine_backends(
        CPU, key=_perm(key, 4096), batch_keys=[_perm(k, 4096) for k in keys],
        search_key=_slots(default, 512))
    out = capsys.readouterr().out
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=4096).astype(np.float32))
    plan = J.sort_plan(4096, 64)
    want = J.LocalEngine().compile(plan)(x, key=key)
    row = (int(want.stats.rounds), plan.round_bound,
           int(want.stats.communication), int(want.stats.dropped), True)
    assert got["backends"] == {"reference": row, "local": row,
                               "sharded": row}
    assert got["batch"] and got["cache"].hits == 1 \
        and got["cache"].misses == 1
    assert "sorts in one round program  sorted=True" in out
    rng.normal(size=(8, 4096))
    q = jnp.asarray(rng.normal(size=512).astype(np.float32))
    piv = jnp.sort(jnp.asarray(rng.normal(size=64).astype(np.float32)))
    ms = J.compile_plan(J.multisearch_plan(512, 64, 16))(q, piv)
    assert got["multisearch"] == (int(ms.stats.rounds), True)


def test_quickstart_tiny_model_matches_jax():
    """The reduced TinyLlama from the JAX init: the same parameter count,
    the loss within 1e-5 relative, every gradient finite."""
    jcfg = jax_get_config("tinyllama-1.1b", reduced=True)
    jmodel = jax_build_model(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = lm_params_from_numpy(tree, get_config("tinyllama-1.1b",
                                                  reduced=True), device="cpu")
    got = quickstart.tiny_model(CPU, model)
    rng = np.random.default_rng(0)
    batch = {"tokens": jnp.asarray(rng.integers(0, jcfg.vocab_size, (4, 32))),
             "labels": jnp.asarray(rng.integers(0, jcfg.vocab_size, (4, 32)))}
    loss, _ = jax.jit(jmodel.loss_fn)(params, batch)
    assert got["params"] == sum(p.size for p in
                                jax.tree_util.tree_leaves(params))
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    assert got["finite"]


# ------------------------------------------------------------ mr_algorithms
@pytest.fixture(scope="module")
def mr_inputs():
    return mr_algorithms.inputs()


def test_mr_shuffle_prefix_and_indexing_match_jax(mr_inputs):
    x = mr_inputs
    got = mr_algorithms.generic_shuffle(CPU, x["dests"])
    box, st = J.shuffle(jnp.asarray(x["dests"]),
                        jnp.arange(256, dtype=jnp.float32).reshape(64, 4),
                        64, 32)
    assert got == {"delivered": int(jnp.sum(box.valid)),
                   "max_received": int(st.max_received),
                   "dropped": int(st.dropped)}
    n = 1000
    got = mr_algorithms.prefix_sums(CPU, LocalEngine(device="cpu"), n=n)
    pres = J.compile_plan(J.prefix_plan(n, 32))(jnp.ones(n, jnp.int32))
    assert (got["rounds"], got["communication"]) == (
        int(pres.stats.rounds), int(pres.stats.communication))
    assert (got["round_bound"], got["comm_bound"]) == J.prefix_cost_bound(
        n, 32)
    assert got["correct"]
    key = jax.random.PRNGKey(0)
    got = mr_algorithms.random_indexing_lemma(CPU, _slots(key, n), n=n)
    c, idx = _cost(lambda c: J.random_indexing(n, key, 32, cost=c))
    np.testing.assert_array_equal(got["idx"].numpy(), np.asarray(idx))
    assert (got["rounds"], got["max_occupancy"]) == (c.rounds,
                                                     c.max_reducer_io)
    assert got["permutation"]


def test_mr_bsp_crcw_and_queues_match_jax(mr_inputs):
    x = mr_inputs
    got = mr_algorithms.bsp_tree_sum(CPU, LocalEngine(device="cpu"), x["bsp_vals"])

    def superstep(t, ids, state, inbox, inbox_valid):
        state = state + jnp.sum(jnp.where(inbox_valid, inbox, 0.0), axis=1)
        stride = 2 ** t
        sender = (ids % (2 * stride)) == stride
        return (state, jnp.where(sender, ids - stride, -1)[:, None],
                state[:, None])
    bres = J.compile_plan(J.bsp_plan(J.BSPProgram(superstep), 7, 8, 64,
                                     jnp.float32(0)))(
        jnp.asarray(x["bsp_vals"]))
    assert (got["rounds"], got["communication"]) == (
        int(bres.stats.rounds), int(bres.stats.communication))
    np.testing.assert_allclose(got["sum"], float(bres.proc_state[0]),
                               rtol=1e-6)
    assert got["sum_ok"]
    data = x["crcw_data"][:256]
    got = mr_algorithms.crcw_histogram(CPU, data)
    prog = J.PRAMProgram(read_addr=lambda s, t: s,
                         compute=lambda s, v, t: (s, s, jnp.ones_like(
                             s, jnp.float32)))
    # jitted, as the JAX package allows (``with_accum``: the cost a
    # ``cost=`` adapter absorbs); eager, it compiles op by op
    _, hist, accum = jax.jit(lambda d: J.simulate_crcw(
        prog, d, jnp.zeros(16, jnp.float32), 1, 32, jnp.add,
        identity=jnp.float32(0), with_accum=True))(jnp.asarray(data))
    c = J.MRCost()
    c.absorb(accum)
    assert got["rounds"] == c.rounds and got["correct"]
    assert got["bound"] == 3 * J.tree_height(256, 16) + 2
    got = mr_algorithms.fifo_queues(CPU)
    qs = J.make_queues(8, 256, jnp.float32(0))
    qs, _ = J.enqueue(qs, jnp.zeros(100, jnp.int32), jnp.arange(100.0))
    rounds = 0
    while int(jnp.sum(qs.size)) > 0:
        qs, _, _ = J.dequeue(qs, 32)
        rounds += 1
    assert got == {"rounds": rounds, "fifo": True}


def test_mr_multisearch_and_sort_match_jax(mr_inputs):
    x = mr_inputs
    q, piv = x["queries"][:512], x["pivots"][:64]
    key = jax.random.PRNGKey(0)
    got = mr_algorithms.pipelined_multisearch(CPU, q, piv,
                                              key=_slots(key, 512))
    jq, jpiv = jnp.asarray(q), jnp.sort(jnp.asarray(piv))
    c, res = _cost(lambda c: J.multisearch(jq, jpiv, 32, cost=c))
    flat = J.multisearch(jq, jpiv, 32, pipelined=False)
    np.testing.assert_array_equal(got["buckets"].numpy(),
                                  np.asarray(res.buckets))
    assert (got["rounds"], got["congestion"], got["flat_congestion"]) == (
        res.rounds, int(res.max_congestion), int(flat.max_congestion))
    sx = x["sort_x"][:2000]
    got = mr_algorithms.sample_sort(CPU, LocalEngine(device="cpu"), sx,
                                    key=_perm(jax.random.PRNGKey(7), 2000))
    sres = J.compile_plan(J.sort_plan(2000, 32))(jnp.asarray(sx))
    assert (got["rounds"], got["communication"]) == (
        int(sres.stats.rounds), int(sres.stats.communication))
    assert got["sorted"] and got["bound"] == 2000 * J.log_M(2000, 32)
    c, _ = _cost(lambda c: J.brute_force_sort(jnp.asarray(sx[:500]), 32,
                                              cost=c))
    assert got["brute_force_communication"] == c.communication


def test_mr_backends_and_hull2d_match_jax(mr_inputs, tmp_path):
    """The sort and the 2-D hull on the port's three backends (the sharded
    one over a one-rank gloo group the example starts) against the JAX
    local engine, at 512 sort keys, 300 + 40 search keys and 600 points."""
    x = mr_inputs
    key = jax.random.PRNGKey(1)
    default = jax.random.PRNGKey(7)
    sx = x["sort_x"]
    with one_rank_group(CPU):
        got = mr_algorithms.three_backends(
            CPU, sx, key=_perm(key, 512), search_key=_slots(default, 300),
            n=512, n_queries=300, n_pivots=40)
        pts = x["pts2"][:600]
        hkey = jax.random.PRNGKey(2)
        hull = mr_algorithms.hull2d_backends(
            CPU, pts, key=_perm(hkey, 600), small_key=_perm(hkey, 400))
    plan = J.sort_plan(512, 32)
    want = J.LocalEngine().compile(plan)(jnp.asarray(sx[:512]), key=key)
    row = (int(want.stats.rounds), int(want.stats.communication),
           int(want.stats.dropped), True)
    assert got["sort"] == {"reference": row, "local": row, "sharded": row}
    bk = J.compile_plan(J.multisearch_plan(300, 40, 32))(
        jnp.asarray(sx[:300]), jnp.sort(jnp.asarray(sx[300:340])))
    np.testing.assert_array_equal(got["buckets"].numpy(),
                                  np.asarray(bk.buckets))
    assert got["multisearch"] == (int(bk.stats.rounds), True)
    for names, sub in ((("reference",), pts[:400]),
                       (("local", "sharded"), pts)):
        plan = J.hull2d_plan(sub.shape[0], 32)
        res = J.LocalEngine().compile(plan)(jnp.asarray(sub), key=hkey)
        for name in names:
            assert hull[name] == (sub.shape[0], int(res.stats.rounds),
                                  J.hull_round_bound(sub.shape[0], 32),
                                  int(res.count), int(res.stats.dropped),
                                  True), name


def test_mr_hull3d_and_lp_match_jax(mr_inputs):
    x = mr_inputs
    got = mr_algorithms.hull3d_crcw(CPU, x["pts3"])
    c, verts = _cost(lambda c: J.convex_hull_3d(x["pts3"], 32,
                                                engine=J.LocalEngine(),
                                                cost=c))
    assert got == {"rounds": c.rounds,
                   "bound": J.hull3d_round_bound(20, 32),
                   "verts": len(verts), "correct": True}
    got = mr_algorithms.lp_min_crcw(CPU, x["c4"], x["A4"], x["b4"])
    c, (_, obj) = _cost(lambda c: J.linear_program_nd(
        x["c4"], x["A4"], x["b4"], 32, engine=J.LocalEngine(), cost=c))
    assert got["rounds"] == c.rounds and got["correct"]
    assert got["bound"] == J.lp_round_bound(12, 4, 32)
    assert abs(got["objective"] - obj) < 1e-4


# ------------------------------------------------------------ serving
def test_serve_queries_matches_jax(capsys):
    """The demo's numbers on the JAX keys: occupancies, latency, the
    backpressure reason, every stat but the run counts (``traces``: the
    port counts runs, the JAX package lowerings), and the sorted values
    and buckets."""
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    default = jax.random.PRNGKey(7)
    got = serve_queries.run(CPU, keys=[_perm(k, 64) for k in keys],
                            search_key=_slots(default, 32))
    out = capsys.readouterr().out
    assert "bit-identical to sequential: True" in out
    engine = J.LocalEngine()
    clock = JVirtualClock()
    svc = JQueryService(engine, max_batch=4, max_wait_ms=5.0,
                        max_pending=4, clock=clock)
    rng = np.random.default_rng(0)
    p_sort = J.sort_plan(64, 16, align=engine.aligned_nodes)
    p_search = J.multisearch_plan(32, 8, 8, align=engine.aligned_nodes)
    xs = [jnp.asarray(rng.normal(size=64).astype(np.float32))
          for _ in range(4)]
    tickets = [svc.submit(p_sort, x, key=k) for x, k in zip(xs, keys)]
    q = jnp.asarray(rng.normal(size=32).astype(np.float32))
    piv = jnp.sort(jnp.asarray(rng.normal(size=8).astype(np.float32)))
    t = svc.submit(p_search, q, piv)
    clock.advance(0.005)
    svc.step()
    for g, w in zip(got["sorts"], tickets):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w.value.values))
    np.testing.assert_array_equal(got["buckets"].numpy(),
                                  np.asarray(t.value.buckets))
    assert got["window_occupancy"] == tickets[0].batch_occupancy
    assert got["deadline_occupancy"] == t.batch_occupancy
    assert got["deadline_latency_ms"] == t.latency * 1e3
    engine.compile(p_sort)      # the example's sequential call: a cache hit
    with pytest.raises(JQueueFull) as e:
        for _ in range(3):
            svc.submit(p_sort, xs[0], key=keys[0])
            svc.submit(p_search, q, piv)
    assert got["queue_full"] == e.value.reason
    svc.drain()
    want = svc.stats()
    assert {k: v for k, v in got["stats"].items() if k != "traces"} == {
        k: v for k, v in want.items() if k != "traces"}


def test_serve_batch_matches_jax(capsys):
    """The 12-request burst on the JAX init: the same rounds, tokens,
    finish order and tokens of every request."""
    jcfg = jax_get_config("tinyllama-1.1b", reduced=True)
    params = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))
    model = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                 get_config("tinyllama-1.1b", reduced=True),
                                 device="cpu")
    got = serve_batch.run(CPU, model)
    assert "drained in" in capsys.readouterr().out
    eng = JServeEngine(jcfg, params, JServeConfig(max_batch=4, max_len=96))
    for r in serve_batch.requests(jcfg.vocab_size):
        eng.submit(JRequest(uid=r.uid, prompt=r.prompt,
                            max_new_tokens=r.max_new_tokens))
    done = eng.run_until_drained()
    s = eng.stats()
    assert (got["stats"]["rounds"], got["stats"]["tokens"]) == (
        s["rounds"], s["tokens"])
    assert got["order"] == [r.uid for r in sorted(
        done, key=lambda r: r.finished_at)]
    assert got["outputs"] == {r.uid: list(r.output) for r in done}
    assert got["max_reducer_io"] == eng.cost.max_reducer_io <= 4

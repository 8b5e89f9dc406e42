"""The searching half of the paper in the port — Lemma 2.2/2.3 prefix sums
and random indexing, Theorem 4.1 multisearch, Theorem 4.2 FIFO queues —
against the JAX package on the same numpy inputs.

The oracles are the JAX ``ReferenceEngine`` and dense ``LocalEngine`` (its
sharded engine is no oracle: its multisearch tests are red in this
checkout).  The random draw (the multisearch ``"batches"`` slot) is the JAX
package's own ``jax.random.randint``, handed to the port as explicit slots;
after that, buckets, int32 sums and every ``CostAccum`` field agree exactly.
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.core as J
from repro_torch.core import (LocalEngine, MRCost, ReferenceEngine,
                              brute_force_multisearch, dequeue, enqueue,
                              get_engine, make_queues, max_leaf_occupancy,
                              multisearch, multisearch_mr, multisearch_opt,
                              multisearch_plan, prefix_cost_bound,
                              prefix_plan, prefix_sum_opt, random_indexing,
                              run_queued, tree_prefix_sum)
from repro_torch.core import engine as port_engine
from repro_torch.testing import assert_same_accum

# float32 prefix sums: the packages reduce each tree row in different
# orders, so sums of n <= 2000 standard normals may differ by a few ulps of
# the running total; 2e-5 relative to the largest |prefix| bounds that.
F32_PREFIX_RTOL = 2e-5


def _jax_engine(name):
    return {"reference": J.ReferenceEngine, "local": J.LocalEngine}[name]()


def _port_engines():
    return [ReferenceEngine(), LocalEngine(device="cpu"),
            get_engine("kernel", device="cpu")]


def _values(seed, n, dtype):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-1000, 1000, n).astype(np.int32)
    return rng.normal(size=n).astype(np.float32)


def _held(got, want, dtype, ctx=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, ctx
    if dtype == "int32":
        np.testing.assert_array_equal(got, want, err_msg=ctx)
    else:
        scale = max(1.0, float(np.max(np.abs(want))))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=F32_PREFIX_RTOL * scale, err_msg=ctx)


@pytest.fixture
def cpu_default_engine(monkeypatch):
    """The deprecated wrappers run on the default engine: a CPU one here."""
    eng = LocalEngine(device="cpu")
    monkeypatch.setattr(port_engine, "default_engine", lambda: eng)
    return eng


# ------------------------------------------------------------ Lemma 2.2
@pytest.mark.parametrize("n,M,dtype,inclusive", [
    (1, 8, "int32", True), (5, 4, "int32", False), (100, 8, "int32", True),
    (1000, 16, "float32", True), (777, 6, "float32", False),
    (2000, 64, "int32", False),
])
def test_prefix_plan_matches_jax(n, M, dtype, inclusive):
    x = _values(n, n, dtype)
    plan = J.prefix_plan(n, M, dtype=dtype, inclusive=inclusive)
    want = J.LocalEngine().compile(plan)(jnp.asarray(x))
    tplan = prefix_plan(n, M, dtype=dtype, inclusive=inclusive)
    assert tplan.schedule() == plan.schedule()
    assert tplan.round_bound == plan.round_bound
    assert tplan.n_nodes == plan.n_nodes
    got = LocalEngine(device="cpu").compile(tplan)(x)
    _held(got.values.numpy(), want.values, dtype)
    assert_same_accum(want.stats, got.stats)


@pytest.mark.parametrize("n,M,dtype,inclusive,oracle", [
    (7, 4, "int32", True, "reference"), (100, 8, "int32", False, "local"),
    (1000, 16, "float32", True, "local"),
    (513, 6, "float32", False, "reference"),
    (2000, 8, "int32", True, "local"),
])
def test_physical_prefix_plan_matches_jax(n, M, dtype, inclusive, oracle):
    x = _values(n + 1, n, dtype)
    plans = {shape: prefix_plan(n, M, dtype=dtype, inclusive=inclusive,
                                physical=True, shape=shape)
             for shape in (True, False)}
    for shape, tplan in plans.items():
        plan = J.prefix_plan(n, M, dtype=dtype, inclusive=inclusive,
                             physical=True, shape=shape)
        assert tplan.schedule() == plan.schedule()
        assert tplan.round_bound == plan.round_bound
        assert tplan.n_nodes == plan.n_nodes
    jeng = _jax_engine(oracle)
    want = jeng.compile(J.prefix_plan(n, M, dtype=dtype, inclusive=inclusive,
                                      physical=True))(jnp.asarray(x))
    outs = []
    for eng in _port_engines():
        for shape, tplan in plans.items():
            got = eng.compile(tplan)(x)
            ctx = f"shape={shape} {jeng.name}/{eng.name}"
            _held(got.values.numpy(), want.values, dtype, ctx)
            assert_same_accum(want.stats, got.stats, ctx=ctx)
            outs.append(got)
        if eng.name == "kernel":
            assert eng.route_log.dense == 0
    # every engine and both footprints: bit-identical
    for other in outs[1:]:
        assert torch.equal(outs[0].values, other.values)
        assert_same_accum(outs[0].stats, other.stats)


def test_prefix_int32_wraps_like_jax():
    """Sums past int32 wrap the same way in both packages, on both
    plans."""
    n, M = 600, 8
    x = np.random.default_rng(3).integers(2**30, 2**31 - 1, n).astype(
        np.int32)
    for physical in (False, True):
        want = J.LocalEngine().compile(J.prefix_plan(
            n, M, physical=physical))(jnp.asarray(x))
        got = LocalEngine(device="cpu").compile(prefix_plan(
            n, M, physical=physical))(x)
        np.testing.assert_array_equal(got.values.numpy(),
                                      np.asarray(want.values))
    np.testing.assert_array_equal(
        prefix_sum_opt(torch.from_numpy(x)).numpy(),
        np.asarray(J.prefix_sum_opt(jnp.asarray(x))))


def test_physical_prefix_on_pallas_engine():
    """One physical prefix query on the JAX kernel engine (interpret mode):
    the port's kernel engine routes every shuffle as it does and agrees."""
    n, M = 1500, 64
    x = _values(9, n, "int32")
    jeng = J.get_engine("pallas")
    want = jeng.compile(J.prefix_plan(n, M, physical=True))(jnp.asarray(x))
    eng = get_engine("kernel", device="cpu")
    got = eng.compile(prefix_plan(n, M, physical=True))(x)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    assert_same_accum(want.stats, got.stats)
    assert eng.route_log.snapshot() == (jeng.route_log.kernel,
                                        jeng.route_log.dense)
    assert eng.route_log.dense == 0


@pytest.mark.parametrize("inclusive", [True, False])
def test_prefix_helpers_match_jax(cpu_default_engine, inclusive):
    x = _values(4, 300, "int32")
    np.testing.assert_array_equal(
        prefix_sum_opt(torch.from_numpy(x), inclusive=inclusive).numpy(),
        np.asarray(J.prefix_sum_opt(jnp.asarray(x), inclusive=inclusive)))
    jcost, cost = J.MRCost(), MRCost()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = J.tree_prefix_sum(jnp.asarray(x), 8, cost=jcost,
                                 inclusive=inclusive)
    with pytest.deprecated_call():
        got = tree_prefix_sum(torch.from_numpy(x), 8, cost=cost,
                              inclusive=inclusive)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert vars(cost) == vars(jcost)
    for n, M in ((1, 8), (1000, 16), (12345, 64)):
        assert prefix_cost_bound(n, M) == J.prefix_cost_bound(n, M)


# ------------------------------------------------------------ Lemma 2.3
def _jax_slots(key, n, n_hat=None):
    n_hat = int(n_hat if n_hat is not None else max(n, 2))
    universe = min(n_hat ** 3, 2**31 - 1)
    return np.array(jax.random.randint(key, (n,), 0, universe,
                                       dtype=jnp.int32))


@pytest.mark.parametrize("n,M,seed", [(10, 4, 0), (500, 16, 1),
                                      (3000, 8, 2)])
def test_random_indexing_matches_jax(n, M, seed):
    key = jax.random.PRNGKey(seed)
    slots = _jax_slots(key, n)
    jcost, cost = J.MRCost(), MRCost()
    want = J.random_indexing(n, key, M, cost=jcost)
    got = random_indexing(n, slots, M, cost=cost, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert sorted(got.tolist()) == list(range(n))
    assert vars(cost) == vars(jcost)
    assert int(max_leaf_occupancy(torch.from_numpy(slots))) == int(
        J.max_leaf_occupancy(jnp.asarray(slots)))


def test_random_indexing_keys_and_occupancy():
    """An int seed and a generator of that seed draw the same slots; the
    draw is a permutation; ties make the occupancy the longest run."""
    a = random_indexing(400, 5, 8, device="cpu")
    b = random_indexing(400, torch.Generator().manual_seed(5), 8,
                        device="cpu")
    assert torch.equal(a, b)
    assert sorted(a.tolist()) == list(range(400))
    slots = np.array([4, 1, 4, 9, 4, 1, 0, 9, 9, 9], np.int32)
    assert int(max_leaf_occupancy(torch.from_numpy(slots))) == 4
    assert int(J.max_leaf_occupancy(jnp.asarray(slots))) == 4
    with pytest.raises(ValueError, match="slots"):
        random_indexing(5, np.arange(4), 8, device="cpu")


# ------------------------------------------------------------- Thm 4.1
def _search_inputs(seed, nq, m, dtype):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        q = rng.integers(-50, 50, nq).astype(np.int32)
        piv = rng.integers(-40, 40, m).astype(np.int32)   # ties and misses
    else:
        q = rng.normal(size=nq).astype(np.float32)
        piv = rng.normal(size=m).astype(np.float32)
    return q, piv


@pytest.mark.parametrize("nq,m,M,dtype,pipelined,oracle", [
    (300, 50, 8, "float32", True, "reference"),
    (64, 7, 4, "int32", True, "local"),
    (1000, 100, 16, "float32", False, "local"),
    (500, 64, 16, "int32", True, "reference"),
    (1200, 200, 32, "float32", True, "local"),
    (1, 5, 4, "float32", True, "local"),
])
def test_multisearch_plan_matches_jax(nq, m, M, dtype, pipelined, oracle):
    q, piv = _search_inputs(nq + m, nq, m, dtype)
    key = jax.random.PRNGKey(nq)
    slots = _jax_slots(key, nq)
    want_buckets = np.searchsorted(np.sort(piv), q, side="left")
    plans = {shape: multisearch_plan(nq, m, M, dtype=dtype,
                                     pipelined=pipelined, shape=shape)
             for shape in (True, False)}
    for shape, tplan in plans.items():
        plan = J.multisearch_plan(nq, m, M, dtype=dtype,
                                  pipelined=pipelined, shape=shape)
        assert tplan.schedule() == plan.schedule()
        assert tplan.round_bound == plan.round_bound
        assert tplan.n_nodes == plan.n_nodes
        assert (tplan.prng_slots, tplan.default_seed) == (
            plan.prng_slots, plan.default_seed)
    jeng = _jax_engine(oracle)
    want = jeng.compile(J.multisearch_plan(nq, m, M, dtype=dtype,
                                           pipelined=pipelined))(
        jnp.asarray(q), jnp.asarray(piv), key=key)
    np.testing.assert_array_equal(np.asarray(want.buckets), want_buckets)
    outs = []
    for eng in _port_engines():
        for shape, tplan in plans.items():
            got = eng.compile(tplan)(q, piv, key=slots)
            ctx = f"shape={shape} {jeng.name}/{eng.name}"
            np.testing.assert_array_equal(got.buckets.numpy(),
                                          want_buckets, err_msg=ctx)
            assert got.buckets.dtype == torch.int32
            assert_same_accum(want.stats, got.stats, ctx=ctx)
            outs.append(got)
        if eng.name == "kernel":
            assert eng.route_log.dense == 0
    # every engine and both footprints: bit-identical
    for other in outs[1:]:
        assert torch.equal(outs[0].buckets, other.buckets)
        assert_same_accum(outs[0].stats, other.stats)


def test_multisearch_capacity_drop_reporting_matches_jax():
    """At capacity about M the w.h.p. congestion event can fire: both
    packages report the same drops, for the same draw."""
    nq, m, M = 2000, 300, 16
    q, piv = _search_inputs(5, nq, m, "float32")
    for seed in (0,):
        key = jax.random.PRNGKey(seed)
        plan = J.multisearch_plan(nq, m, M, capacity=M)
        want = J.LocalEngine().compile(plan)(jnp.asarray(q),
                                             jnp.asarray(piv), key=key)
        assert int(want.stats.dropped) > 0
        got = LocalEngine(device="cpu").compile(multisearch_plan(
            nq, m, M, capacity=M))(q, piv, key=_jax_slots(key, nq))
        assert_same_accum(want.stats, got.stats)
        np.testing.assert_array_equal(got.buckets.numpy(),
                                      np.asarray(want.buckets))


def test_multisearch_on_pallas_engine():
    """One multisearch query on the JAX kernel engine (interpret mode): the
    port's kernel engine routes every shuffle as it does and agrees."""
    nq, m, M = 400, 60, 16
    q, piv = _search_inputs(6, nq, m, "float32")
    key = jax.random.PRNGKey(6)
    jeng = J.get_engine("pallas")
    want = jeng.compile(J.multisearch_plan(nq, m, M))(
        jnp.asarray(q), jnp.asarray(piv), key=key)
    eng = get_engine("kernel", device="cpu")
    got = eng.compile(multisearch_plan(nq, m, M))(q, piv,
                                                  key=_jax_slots(key, nq))
    np.testing.assert_array_equal(got.buckets.numpy(),
                                  np.asarray(want.buckets))
    assert_same_accum(want.stats, got.stats)
    # every shuffle on the kernels in both packages (the JAX engine counts
    # the K steady rounds' scan once; the port counts each round)
    plan = multisearch_plan(nq, m, M)
    n_shuffles = sum(s.rounds for s in plan.stages if s.shuffles)
    assert eng.route_log.snapshot() == (n_shuffles, 0)
    assert jeng.route_log.dense == 0 and jeng.route_log.kernel > 0


def test_multisearch_batch_equals_singles():
    nq, m, M, B = 400, 60, 8, 4
    rng = np.random.default_rng(7)
    qs = rng.normal(size=(B, nq)).astype(np.float32)
    pivs = rng.normal(size=(B, m)).astype(np.float32)
    exe = get_engine("kernel", device="cpu").compile(
        multisearch_plan(nq, m, M))
    keys = [3, torch.Generator().manual_seed(4),
            _jax_slots(jax.random.PRNGKey(5), nq), 6]
    out = exe.batch(B)(qs, pivs, keys=keys)
    keys[1] = torch.Generator().manual_seed(4)
    for i in range(B):
        one = exe(qs[i], pivs[i], key=keys[i])
        assert torch.equal(out.buckets[i], one.buckets)
        for fb, f1 in zip(out.stats, one.stats):
            assert torch.equal(fb[i], f1)
        np.testing.assert_array_equal(
            one.buckets.numpy(),
            np.searchsorted(np.sort(pivs[i]), qs[i], side="left"))


@pytest.mark.parametrize("nq,m,M,pipelined", [
    (300, 50, 8, True), (1000, 100, 16, True), (400, 64, 8, False),
])
def test_dense_multisearch_matches_jax(nq, m, M, pipelined):
    q, piv = _search_inputs(nq, nq, m, "float32")
    key = jax.random.PRNGKey(nq)
    jcost, cost = J.MRCost(), MRCost()
    want = J.multisearch(jnp.asarray(q), jnp.asarray(np.sort(piv)), M,
                         key=key, cost=jcost, pipelined=pipelined)
    got = multisearch(torch.from_numpy(q), torch.from_numpy(np.sort(piv)), M,
                      key=_jax_slots(key, nq), cost=cost,
                      pipelined=pipelined)
    np.testing.assert_array_equal(got.buckets.numpy(),
                                  np.asarray(want.buckets))
    assert got.max_congestion == want.max_congestion
    assert got.rounds == want.rounds
    assert vars(cost) == vars(jcost)


def test_search_helpers_match_jax(cpu_default_engine):
    q, piv = _search_inputs(8, 500, 64, "float32")
    np.testing.assert_array_equal(
        multisearch_opt(torch.from_numpy(q), torch.from_numpy(piv)).numpy(),
        np.asarray(J.multisearch_opt(jnp.asarray(q), jnp.asarray(piv))))
    jcost, cost = J.MRCost(), MRCost()
    want = J.brute_force_multisearch(jnp.asarray(q[:100]),
                                     jnp.asarray(piv[:30]), 8, cost=jcost)
    got = brute_force_multisearch(torch.from_numpy(q[:100]),
                                  torch.from_numpy(piv[:30]), 8, cost=cost)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert vars(cost) == vars(jcost)
    key = jax.random.PRNGKey(2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = J.multisearch_mr(jnp.asarray(q), jnp.asarray(piv), 8,
                                engine=J.LocalEngine(), key=key)
    with pytest.deprecated_call():
        got = multisearch_mr(q, piv, 8, key=_jax_slots(key, 500))
    np.testing.assert_array_equal(got.buckets.numpy(),
                                  np.asarray(want.buckets))
    assert_same_accum(want.stats, got.stats)


# ------------------------------------------------------------- Thm 4.2
class FifoModel:
    """Plain Python FIFO queues with bounded rings: the port's oracle."""

    def __init__(self, n_nodes, cap):
        self.q = [[] for _ in range(n_nodes)]
        self.cap = cap

    def enqueue(self, dests, items):
        overflow = 0
        for d, x in zip(dests, items):
            if d < 0:
                continue
            if len(self.q[d]) < self.cap:
                self.q[d].append(x)
            else:
                overflow += 1
        return overflow

    def dequeue(self, M):
        out = [q[:M] for q in self.q]
        self.q = [q[M:] for q in self.q]
        return out


def _served(items, valid):
    items, valid = items.numpy(), valid.numpy()
    return [items[v][valid[v]].tolist() for v in range(items.shape[0])]


@pytest.mark.parametrize("dests", [[3, -1], [-1, 3]])
def test_dead_item_writes_nothing(dests):
    """A dead item (dest < 0) beside a live one for the last queue: the
    live item is kept whatever the order (the JAX package's enqueue loses
    it for [3, -1]; ROADMAP Queue C)."""
    q = make_queues(4, 4, torch.tensor(0.0), device="cpu")
    model = FifoModel(4, 4)
    items = [10.0, 20.0]
    q, overflow = enqueue(q, torch.tensor(dests, dtype=torch.int32),
                          torch.tensor(items))
    assert int(overflow) == model.enqueue(dests, items) == 0
    assert q.size.tolist() == [len(x) for x in model.q]
    q, out, valid = dequeue(q, 4)
    assert _served(out, valid) == model.dequeue(4)


def test_queues_against_fifo_model():
    """Bursts with dead items, wrap-around and ring overflow, against the
    plain FIFO model, payload a nest of a scalar and a vector leaf."""
    V, cap, M = 5, 8, 3
    rng = np.random.default_rng(11)
    q = make_queues(V, cap, {"a": torch.tensor(0, dtype=torch.int32),
                             "b": torch.zeros(2)}, device="cpu")
    model = FifoModel(V, cap)
    uid = 0
    for step in range(12):
        n = int(rng.integers(0, 12))
        dests = rng.integers(-2, V, n).astype(np.int32)
        ids = np.arange(uid, uid + n, dtype=np.int32)
        uid += n
        payload = {"a": torch.from_numpy(ids),
                   "b": torch.from_numpy(np.stack([ids, -ids], 1)
                                         .astype(np.float32))}
        q, overflow = enqueue(q, torch.from_numpy(dests), payload)
        assert int(overflow) == model.enqueue(dests.tolist(), ids.tolist())
        q, out, valid = dequeue(q, M)
        want = model.dequeue(M)
        assert _served(out["a"], valid) == want
        for v in range(V):
            b = out["b"][v][valid[v]].numpy()
            np.testing.assert_array_equal(b[:, 0], want[v])
            np.testing.assert_array_equal(b[:, 1], [-x for x in want[v]])
        assert q.size.tolist() == [len(x) for x in model.q]


# The JAX enqueue's dead items write back an old value over the last
# node's ring slot 0 (ROADMAP Queue C), so the parity inputs below leave
# the last node empty: there the JAX package's result is the FIFO one.
def test_enqueue_dequeue_match_jax():
    V, cap, M = 6, 16, 4
    rng = np.random.default_rng(12)
    jq = J.make_queues(V, cap, jnp.float32(0))
    q = make_queues(V, cap, torch.tensor(0.0), device="cpu")
    for step in range(6):
        dests = rng.integers(-1, V - 1, 10).astype(np.int32)
        vals = rng.normal(size=10).astype(np.float32)
        jcost, cost = J.MRCost(), MRCost()
        jq, jov = J.enqueue(jq, jnp.asarray(dests), jnp.asarray(vals),
                            cost=jcost)
        q, ov = enqueue(q, torch.from_numpy(dests), torch.from_numpy(vals),
                        cost=cost)
        assert int(ov) == int(jov)
        assert vars(cost) == vars(jcost)
        jq, jout, jvalid = J.dequeue(jq, M)
        q, out, valid = dequeue(q, M)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        np.testing.assert_array_equal(out.numpy()[valid.numpy()],
                                      np.asarray(jout)[np.asarray(jvalid)])
        np.testing.assert_array_equal(q.buf.numpy(), np.asarray(jq.buf))
        np.testing.assert_array_equal(q.head.numpy(), np.asarray(jq.head))
        np.testing.assert_array_equal(q.size.numpy(), np.asarray(jq.size))


def test_run_queued_matches_jax():
    """A forwarding chain 0 -> 1 -> ... -> V-2 (the sink absorbs; the last
    node stays empty, see above), driven by run_queued in both
    packages."""
    V, M, cap = 6, 4, 64
    jq = J.make_queues(V, cap, jnp.int32(0))
    jq, _ = J.enqueue(jq, jnp.zeros((30,), jnp.int32),
                      jnp.arange(30, dtype=jnp.int32))
    q = make_queues(V, cap, torch.tensor(0, dtype=torch.int32), device="cpu")
    q, _ = enqueue(q, torch.zeros(30, dtype=torch.int32),
                   torch.arange(30, dtype=torch.int32))
    jsink, sink = [], []

    def jf(r, ids, items, valid):
        dests = jnp.where(valid, jnp.minimum(ids[:, None] + 1, V - 2), -1)
        dests = jnp.where((ids[:, None] == V - 2) & valid, -1, dests)
        jsink.extend(np.asarray(items[V - 2])[np.asarray(valid[V - 2])]
                     .tolist())
        return dests, items

    def f(r, ids, items, valid):
        dests = torch.where(valid, (ids[:, None] + 1).clamp_max(V - 2), -1)
        dests = torch.where((ids[:, None] == V - 2) & valid, -1, dests)
        sink.extend(items[V - 2][valid[V - 2]].tolist())
        return dests, items

    jcost, cost = J.MRCost(), MRCost()
    jq = J.run_queued(jf, jq, M, n_rounds=50, cost=jcost)
    q = run_queued(f, q, M, n_rounds=50, cost=cost)
    assert sink == jsink == list(range(30))
    assert vars(cost) == vars(jcost)
    assert int(q.size.sum()) == 0
    with pytest.raises(RuntimeError, match="ring buffer exhausted"):
        run_queued(lambda r, ids, items, valid: (
            torch.zeros_like(valid, dtype=torch.int32), items),
            enqueue(make_queues(2, 4, torch.tensor(0.0), device="cpu"),
                    torch.zeros(4, dtype=torch.int32), torch.ones(4))[0],
            4, n_rounds=3)

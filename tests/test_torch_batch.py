"""The batched round program: ``Executable.batch(B)`` in the port against B
single port calls and the JAX package's vmapped ``exe.batch(B)``.

On the batchable ``LocalEngine`` (dense and kernel shuffle) B queries of
every plan family run as one program with a leading batch axis; each row
equals the single call bit for bit, and the JAX package's batch on its
``LocalEngine`` and on the Pallas engine in interpret mode (the LP's vertex
and objective within the LP tolerances of tests/test_torch_geometry.py,
every other leaf and every stats field exactly).  A spy counts the kernel
and shuffle calls: a batch makes as many as one query.  ``ReferenceEngine``
and the fault proxy keep the loop over single calls.  Also here: the plain
batched ``bincount_tiles`` against the JAX kernel under ``jax.vmap``, the
tracing contract of a batch, the service's faulted demo against the JAX
package's run, multisearch's NaN queries, and the sort and bitonic
behaviour on ``+inf``, NaN and ties that the port keeps from the JAX
package.  Random draws are the JAX package's, handed to the port as sample
indices.
"""
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.core as J
import repro.obs as JO
import repro.serve as JS
import repro.serve.loadgen as JL
from repro.core import recovery as JR
from repro.kernels.bincount import bincount_tiles as jax_bincount_tiles
from repro.kernels.bitonic_sort import bitonic_sort as jax_bitonic_sort
import repro_torch.core as T
from repro_torch._tree import tree_leaves
from repro_torch.core import (BSPProgram, LocalEngine, ReferenceEngine,
                              get_engine)
from repro_torch.core.multisearch import multisearch as port_multisearch
from repro_torch.core.recovery import FaultConfig, with_faults
from repro_torch.kernels import bincount, ops
from repro_torch.obs import Tracer
from repro_torch.serve import QueryService, VirtualClock, loadgen

B = 3
FAMILIES = ["sort", "multisearch", "prefix", "prefix-physical", "funnel",
            "bsp", "hull2d", "hull3d", "lp"]


@pytest.fixture(autouse=True)
def jax_trace_state_clean(monkeypatch):
    """The JAX package's tracer calls ``jax.core.trace_state_clean``, which
    some jax releases keep only as ``jax._src.core.trace_state_clean``."""
    if not hasattr(jax.core, "trace_state_clean"):
        from jax._src import core as jax_src_core
        monkeypatch.setattr(jax.core, "trace_state_clean",
                            jax_src_core.trace_state_clean, raising=False)


def _allreduce(m):
    """tests/test_paper_algorithms.py's tree all-reduce, for one query."""
    xp = jnp if m is J else torch

    def superstep(t, ids, state, inbox, inbox_valid):
        state = state + xp.sum(xp.where(inbox_valid, inbox, 0.0), 1)
        stride = 2 ** t
        sender = (ids % (2 * stride)) == stride
        return state, xp.where(sender, ids - stride, -1)[:, None], \
            state[:, None]
    return m.BSPProgram(superstep)


def _plan(m, family):
    """Every family at a test-tiny size, built by either package."""
    zero = jnp.float32(0) if m is J else torch.tensor(0.0)
    add = jnp.add if m is J else torch.add
    return {
        "sort": lambda: m.sort_plan(48, 8),
        "multisearch": lambda: m.multisearch_plan(64, 12, 8),
        "prefix": lambda: m.prefix_plan(100, 8),
        "prefix-physical": lambda: m.prefix_plan(100, 8, physical=True),
        "funnel": lambda: m.funnel_write_plan(40, 5, 8, add, identity=0.0),
        "bsp": lambda: m.bsp_plan(_allreduce(m), 4, 4, 16, zero),
        "hull2d": lambda: m.hull2d_plan(256, 16),
        "hull3d": lambda: m.hull3d_plan(8, 8),
        "lp": lambda: m.lp_plan(16, 2, 8),
    }[family]()


def _inputs(family, seed=0):
    """B stacked queries of ``family`` from a numpy seed."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    if family == "sort":
        return (rng.normal(size=(B, 48)).astype(f32),)
    if family == "multisearch":
        return (rng.normal(size=(B, 64)).astype(f32),
                np.sort(rng.normal(size=(B, 12)).astype(f32), 1))
    if family.startswith("prefix"):
        return (rng.integers(-50, 50, (B, 100)).astype(np.int32),)
    if family == "funnel":
        return (rng.integers(-1, 5, (B, 40)).astype(np.int32),
                rng.normal(size=(B, 40)).astype(f32),
                rng.normal(size=(B, 5)).astype(f32))
    if family == "bsp":
        return (rng.normal(size=(B, 16)).astype(f32),)
    if family == "hull2d":
        return (rng.normal(size=(B, 256, 2)).astype(f32),)
    if family == "hull3d":
        return (rng.normal(size=(B, 8, 3)).astype(f32),)
    return (rng.normal(size=(B, 2)).astype(f32),
            rng.normal(size=(B, 16, 2)).astype(f32),
            rng.uniform(1.0, 2.0, (B, 16)).astype(f32))


def _keys(family, seed=0):
    """(JAX keys, the port's per-query keys): the sample indices or slots
    the JAX package draws from each key, or None where nothing is drawn."""
    jkeys = jax.random.split(jax.random.PRNGKey(seed + 11), B)
    if family in ("sort", "hull2d"):
        n = 48 if family == "sort" else 256
        return jkeys, [np.asarray(jax.random.permutation(k, n))
                       for k in jkeys]
    if family == "multisearch":
        return jkeys, [np.asarray(jax.random.randint(
            k, (64,), 0, 64 ** 3, dtype=jnp.int32)) for k in jkeys]
    return jkeys, None


def _leaves(tree):
    return [l.cpu().numpy() if isinstance(l, torch.Tensor) else np.asarray(l)
            for l in tree_leaves(tree)]


def assert_tree_equal(a, b, ctx=""):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), ctx
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, ctx
        np.testing.assert_array_equal(x, y, err_msg=ctx)


def assert_matches_jax(want, got, family, ctx=""):
    """Every leaf bit for bit; the LP's x and objective within the LP
    tolerances of tests/test_torch_geometry.py (float32 basis solves)."""
    wl = [np.asarray(l) for l in jax.tree_util.tree_leaves(want)]
    gl = _leaves(got)
    assert len(wl) == len(gl), ctx
    for i, (g, w) in enumerate(zip(gl, wl)):
        assert g.dtype == w.dtype and g.shape == w.shape, (ctx, i)
        if family == "lp" and g.dtype == np.float32 and i < 2:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4,
                                       err_msg=ctx)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{ctx} leaf {i}")


def _row(tree, i):
    return tuple(x[i] for x in tree)


def _port_engines():
    return [LocalEngine(device="cpu"), get_engine("kernel", device="cpu")]


# ---------------------------------------------------------------------------
# Every family: batch == singles == the JAX package's vmapped batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_batch_equals_singles_and_jax_batch(family):
    inputs = _inputs(family)
    jkeys, keys = _keys(family)
    jplan, tplan = _plan(J, family), _plan(T, family)
    jin = tuple(jnp.asarray(x) for x in inputs)
    wants = {name: J.get_engine(name).compile(jplan).batch(B)(*jin,
                                                              keys=jkeys)
             for name in ("local", "pallas")}
    for eng in _port_engines():
        exe = eng.compile(tplan)
        got = exe.batch(B)(*inputs, keys=keys)
        for name, want in wants.items():
            assert_matches_jax(want, got, family, f"{eng.name} vs {name}")
        for i in range(B):
            single = exe(*_row(inputs, i),
                         key=None if keys is None else keys[i])
            assert_tree_equal([l[i] for l in tree_leaves(got)], single,
                              f"{family} {eng.name} row {i}")


@pytest.mark.parametrize("family", ["sort", "multisearch", "hull2d", "lp"])
def test_loop_engines_keep_single_calls(family):
    """ReferenceEngine and the fault proxy cannot batch: their batch runs
    the single calls one after another, with the same rows."""
    inputs = _inputs(family, seed=1)
    jkeys, keys = _keys(family, seed=1)
    tplan = _plan(T, family)
    want = LocalEngine(device="cpu").compile(tplan).batch(B)(*inputs,
                                                             keys=keys)
    for eng in (ReferenceEngine(),
                with_faults(get_engine("kernel", device="cpu"),
                            FaultConfig())):
        assert not eng.batchable
        exe = eng.compile(tplan)
        assert_tree_equal(exe.batch(B)(*inputs, keys=keys), want,
                          f"{family} {eng.name}")
        assert exe.trace_count == B
    assert with_faults(LocalEngine(device="cpu"), FaultConfig()).injector \
        .calls == 0


class _Spy:
    """Counts the calls of the kernels' entry points and of the engine's
    batched shuffle."""

    def __init__(self, monkeypatch, engine):
        self.calls = {"bincount_tiles": 0, "bitonic_sort": 0,
                      "monotone_chain": 0, "shuffle": 0}
        for name in ("bincount_tiles", "bitonic_sort", "monotone_chain"):
            monkeypatch.setattr(ops, name, self._wrap(name,
                                                      getattr(ops, name)))
        monkeypatch.setattr(engine, "shuffle_batch",
                            self._wrap("shuffle", engine.shuffle_batch))

    def _wrap(self, name, fn):
        def spy(*args, **kwargs):
            self.calls[name] += 1
            return fn(*args, **kwargs)
        return spy

    def take(self):
        out = dict(self.calls)
        for k in self.calls:
            self.calls[k] = 0
        return out


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_batch_makes_as_many_kernel_and_shuffle_calls_as_one_query(
        monkeypatch, family, impl):
    eng = LocalEngine(impl, device="cpu")
    spy = _Spy(monkeypatch, eng)
    inputs = _inputs(family, seed=2)
    _, keys = _keys(family, seed=2)
    exe = eng.compile(_plan(T, family))
    exe(*_row(inputs, 0), key=None if keys is None else keys[0])
    one = spy.take()
    exe.batch(B)(*inputs, keys=keys)
    assert spy.take() == one
    if family in ("sort", "multisearch", "hull2d", "funnel", "bsp"):
        assert one["shuffle"] > 0
    if impl == "kernel":
        assert one["bincount_tiles"] == one["bitonic_sort"] == one["shuffle"]
    else:
        assert one["bincount_tiles"] == one["bitonic_sort"] == 0
    if family == "hull2d":
        assert one["monotone_chain"] == 3        # merge-0, merge-1, finalize
    assert eng.route_log.dense == 0 or impl == "dense"


def test_batch_routes_as_one_query_and_names_dropping_rows():
    """The route guard reads one query's (n, V): a batch takes the route
    its queries take alone, counted once per batched shuffle.  A batch's
    drops are read once and name their rows."""
    eng = get_engine("kernel", device="cpu")
    plan = T.sort_plan(48, 8)
    exe = eng.compile(plan)
    xs = _inputs("sort", seed=3)[0]
    exe(xs[0], key=1)
    single = eng.route_log.snapshot()
    eng.route_log.reset()
    out = exe.batch(B)(xs, keys=[1, 2, 3])
    assert eng.route_log.snapshot() == single == (2, 0)
    eng.require_no_drops(out.stats, "a batch")
    # all of query 1's keys fall in one bucket, past its capacity
    skew = np.stack([xs[0], np.zeros(48, np.float32), xs[2]])
    res = exe.batch(B)(skew, keys=[1, 2, 3])
    assert [int(d) > 0 for d in res.stats.dropped] == [False, True, False]
    with pytest.raises(RuntimeError, match=re.escape("queries [1] of a batch")):
        eng.require_no_drops(res.stats, "a batch")


def test_batch_records_only_route_decisions():
    """Under a recording tracer a batch on the batchable engine records no
    ``exe.call``, ``plan.execute``, ``plan.stage`` or ``engine.round``, as
    the JAX package's jitted ``vmap`` records none.  The port records one
    ``shuffle.route`` per batched shuffle with one query's n, on every
    call; the JAX package records the same events once, when it traces a
    batch size."""
    xs = _inputs("sort", seed=4)[0]
    jkeys, keys = _keys("sort", seed=4)
    jtr, tr = JO.Tracer(), Tracer()
    jexe = J.get_engine("pallas", tracer=jtr).compile(J.sort_plan(48, 8))
    exe = get_engine("kernel", device="cpu", tracer=tr).compile(
        T.sort_plan(48, 8))
    for _ in range(2):
        jexe.batch(B)(jnp.asarray(xs), keys=jkeys)
        exe.batch(B)(xs, keys=keys)

    def routes(t):
        return [(e.attrs["impl"], e.attrs["n"], e.attrs["n_nodes"])
                for e in t.events() if e.kind == "shuffle.route"]
    assert {e.kind for e in tr.events()} == {"cache.miss", "shuffle.route"}
    assert {e.kind for e in jtr.events()} <= {"cache.miss", "shuffle.route"}
    assert routes(tr) == routes(jtr) * 2
    assert routes(tr)[0] == ("kernel", 48, 6)
    assert "exe.calls" not in tr.metrics.snapshot()["counters"]


# ---------------------------------------------------------------------------
# bincount_tiles with a batch axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Bq,T_,tile_n,V", [
    (3, 5, 16, 8), (2, 4, 7, 7), (4, 1, 32, 5), (2, 3, 8, 1), (3, 6, 4, 13),
])
def test_batched_bincount_tiles_plain_matches_jax_vmap(Bq, T_, tile_n, V):
    rng = np.random.default_rng(Bq * 100 + T_ * 10 + V)
    tiles = rng.integers(-3, V + 3, (Bq, T_, tile_n)).astype(np.int32)
    tiles[0, -1] = -1                         # an empty tile
    tiles[-1, 0] = V                          # a tile of ids outside [0, V)
    want = jax.vmap(lambda t: jax_bincount_tiles(t, V, interpret=True))(
        jnp.asarray(tiles))
    got = ops.bincount_tiles(torch.from_numpy(tiles), V)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for b in range(Bq):
        for g, w in zip(got, bincount.bincount_tiles_plain(
                torch.from_numpy(tiles[b]), V)):
            assert torch.equal(g[b], w)


# ---------------------------------------------------------------------------
# The query service: batched dispatches, and the faulted demo vs JAX
# ---------------------------------------------------------------------------

DEMO = dict(n_queries=48, seed=7)     # the JAX package's obs demo traffic


def _demo(pkg, faults):
    """The observability demo's serve run on a virtual clock, traced, on
    the kernel engine behind the fault proxy."""
    is_jax = pkg == "jax"
    clock = JS.VirtualClock() if is_jax else VirtualClock()
    tr = JO.Tracer(clock=clock) if is_jax else Tracer(clock=clock)
    if is_jax:
        eng = JR.with_faults(J.LocalEngine(tracer=tr),
                             JR.FaultConfig(**faults))
    else:
        eng = with_faults(get_engine("kernel", device="cpu", tracer=tr),
                          FaultConfig(**faults))
    lg = JL if is_jax else loadgen
    svc = (JS.QueryService if is_jax else QueryService)(
        eng, max_batch=4, max_wait_ms=5.0, max_retries=2, clock=clock)
    cfg = lg.TrafficConfig(**DEMO)
    suite = lg.make_suite(eng, cfg)
    svc.register(suite["sort"][0], max_wait_ms=2.0)
    row = lg.run_open_loop(svc, lg.make_workload(suite, cfg),
                           offered_qps=800.0, clock=clock,
                           process="poisson", seed=cfg.seed)
    row.pop("metrics", None)
    events = [(e.kind, e.attrs) for e in tr.events()
              if e.kind.startswith(("fault.", "recover.", "serve.dispatch",
                                    "serve.requeue"))
              and e.kind != "serve.dispatch"]
    families = {t.uid - 1: t.plan_name for t in svc.finished}
    results = {t.uid - 1: t.value for t in svc.finished if not t.failed}
    return row, events, families, results


def test_faulted_demo_follows_the_jax_dispatches():
    """With shard failures at shuffle attempts 3 and 11 the port's service
    pads each window on the fault proxy and runs every lane, as the JAX
    package's does, so the failures hit the same dispatches: the fault,
    dispatch-error and requeue events, the row and the results' outputs
    equal the JAX package's."""
    faults = dict(fail_at=(3, 11), seed=7)
    jrow, jevents, jfam, jres = _demo("jax", faults)
    row, events, fam, res = _demo("port", faults)
    assert row == jrow
    assert events == jevents
    assert [k for k, _ in events].count("fault.failure") == 2
    assert fam == jfam and sorted(res) == sorted(jres)
    # the workloads' keys are each package's own seeds, so the randomized
    # families' per-round stats differ; their outputs do not
    for uid in res:
        assert_matches_jax(jres[uid]._replace(stats=None),
                           res[uid]._replace(stats=None), fam[uid],
                           f"query {uid} ({fam[uid]})")


def test_service_dispatch_is_one_batched_program(monkeypatch):
    """On the batchable engine a dispatch of k live queries is one program:
    one shuffle a round for the k queries."""
    eng = get_engine("kernel", device="cpu")
    spy = _Spy(monkeypatch, eng)
    plan = T.sort_plan(48, 8)
    svc = QueryService(eng, max_batch=4, max_wait_ms=5.0,
                       clock=VirtualClock())
    xs = _inputs("sort", seed=5)[0]
    tickets = [svc.submit(plan, x, key=i) for i, x in enumerate(xs)]
    svc.clock.advance(0.005)
    assert svc.step() == B
    assert spy.take()["shuffle"] == 2
    exe = eng.compile(plan)
    for i, t in enumerate(tickets):
        assert_tree_equal(t.value, exe(xs[i], key=i))
    assert svc.pad_slots == 1 and eng.compile(plan).trace_count == 1 + B


# ---------------------------------------------------------------------------
# Multisearch: a NaN query lands in bucket 0, as in the JAX package
# ---------------------------------------------------------------------------

def _nan_queries(n_q=64, m=100, seed=9):
    rng = np.random.default_rng(seed)
    piv = np.sort(rng.normal(size=m).astype(np.float32))
    q = rng.normal(size=n_q).astype(np.float32)
    q[:5] = [np.nan, -np.inf, np.inf, piv[5], 0.0]
    return q, piv


def test_nan_query_lands_in_bucket_zero_like_jax():
    q, piv = _nan_queries()
    M = 16
    jplan = J.multisearch_plan(64, 100, M)
    key = jax.random.PRNGKey(3)
    want = np.asarray(J.LocalEngine().compile(jplan)(
        jnp.asarray(q), jnp.asarray(piv), key=key).buckets)
    assert want[0] == 0 and want[1] == 0 and want[2] == 100
    slots = np.asarray(jax.random.randint(key, (64,), 0, 64 ** 3,
                                          dtype=jnp.int32))
    tplan = T.multisearch_plan(64, 100, M)
    for eng in [ReferenceEngine()] + _port_engines():
        exe = eng.compile(tplan)
        got = exe(q, piv, key=slots).buckets.numpy()
        np.testing.assert_array_equal(got, want, err_msg=eng.name)
        qs = np.stack([q, q[::-1].copy(), q])
        pivs = np.stack([piv] * 3)
        batch = exe.batch(3)(qs, pivs, keys=[slots] * 3).buckets.numpy()
        np.testing.assert_array_equal(batch[0], want, err_msg=eng.name)
        np.testing.assert_array_equal(batch[2], want, err_msg=eng.name)
        np.testing.assert_array_equal(
            batch[1], exe(qs[1], piv, key=slots).buckets.numpy())
        assert batch[1][-1] == 0                    # the NaN, reversed
    jdense = np.asarray(J.multisearch(jnp.asarray(q), jnp.asarray(piv),
                                      M).buckets)
    dense = port_multisearch(torch.from_numpy(q), torch.from_numpy(piv), M)
    np.testing.assert_array_equal(dense.buckets.numpy(), jdense)
    assert dense.buckets[0] == 0
    # the plain searchsorted of multisearch_opt stays as it is, in both
    assert int(T.multisearch_opt(torch.from_numpy(q),
                                 torch.from_numpy(piv))[0]) == 100
    assert int(J.multisearch_opt(jnp.asarray(q), jnp.asarray(piv))[0]) == 100


# ---------------------------------------------------------------------------
# Behaviour the port keeps from the JAX package: +inf, NaN and ties
# ---------------------------------------------------------------------------

def test_padded_sort_loses_inf_and_nan_keys_in_both_packages():
    """``sort_plan`` pads empty mailbox slots with the dtype's maximum, so
    a ``+inf`` or NaN key sorts after the padding and is cut off: a
    4096-key float32 sort at M = 256 with two ``+inf`` and three NaN keys
    returns five ``3.4028235e+38`` in their place, in both packages and on
    both shuffles.  (The main path's composite shuffle keys are unique
    int32s, so no engine output depends on this.)"""
    rng = np.random.default_rng(12)
    x = rng.normal(size=4096).astype(np.float32)
    x[[7, 900]] = np.inf
    x[[3, 1000, 4000]] = np.nan
    key = jax.random.PRNGKey(5)
    want = np.asarray(J.LocalEngine().compile(J.sort_plan(4096, 256))(
        jnp.asarray(x), key=key).values)
    big = np.float32(3.4028235e+38)
    assert (want == big).sum() == 5 and not np.isinf(want).any()
    assert not np.isnan(want).any()
    idx = np.asarray(jax.random.permutation(key, 4096))
    for eng in _port_engines():
        got = eng.compile(T.sort_plan(4096, 256))(x, key=idx)
        np.testing.assert_array_equal(got.values.numpy(), want,
                                      err_msg=eng.name)


def test_bitonic_tie_order_differs_between_the_network_and_plain():
    """On tied keys the JAX bitonic network and the port's plain version
    (a stable argsort) order the values differently; ``+inf`` and NaN keys
    survive the plain version, where the network's max-padding loses an
    ``+inf`` key of a row that is not a power of two wide."""
    keys = np.array([[1, 1, 1, 0]], np.int32)
    vals = np.array([[0, 1, 2, 3]], np.int32)
    _, jv = jax_bitonic_sort(jnp.asarray(keys), jnp.asarray(vals),
                             interpret=True)
    assert np.asarray(jv).tolist() == [[3, 0, 2, 1]]
    _, tv = ops.bitonic_sort(torch.from_numpy(keys), torch.from_numpy(vals))
    assert tv.tolist() == [[3, 0, 1, 2]]
    fk = np.array([[np.inf, 1.0, 2.0]], np.float32)
    fv = np.array([[0, 1, 2]], np.int32)
    jk, jv = jax_bitonic_sort(jnp.asarray(fk), jnp.asarray(fv),
                              interpret=True)
    assert np.asarray(jk).tolist() == [[1.0, 2.0, float(np.float32(3.4028235e+38))]]
    assert np.asarray(jv)[0, :2].tolist() == [1, 2]
    tk, tv = ops.bitonic_sort(torch.from_numpy(fk), torch.from_numpy(fv))
    assert tk.tolist() == [[1.0, 2.0, float("inf")]] and tv.tolist() == [[1, 2, 0]]
    nk, _ = ops.bitonic_sort(torch.tensor([[np.nan, 1.0, 0.0, 2.0]]),
                             torch.arange(4, dtype=torch.int32)[None])
    assert nk[0, :3].tolist() == [0.0, 1.0, 2.0] and torch.isnan(nk[0, 3])

"""The query service in the port (``repro_torch.serve.QueryService`` and
``repro_torch.serve.loadgen``) against the JAX package's ``repro.serve``.

The contracts: coalesced results equal the JAX package's service and
sequential calls bit for bit for all seven plan families; both dispatch
triggers (window full, deadline) fire as in the JAX package, on a
``VirtualClock`` with exact latencies; admission control, the plan-cache
thrash guard, retry and requeue behave as there; a dispatch on the
batchable engine runs its live queries as one program, and on the fault
proxy the padded window, while ``stats()`` keeps the JAX package's window
accounting;
and the open-loop row of the JAX package's observability demo traffic
equals the JAX package's.  Random draws are the JAX package's, handed to
the port as sample indices.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.core as J
import repro.obs as JO
import repro.serve as JS
import repro.serve.loadgen as JL
import repro_torch.core as T
from repro_torch._tree import tree_leaves
from repro_torch.core import LocalEngine, ReferenceEngine, get_engine
from repro_torch.core.recovery import FaultConfig, ShardFailure, with_faults
from repro_torch.obs import Tracer, summarize
from repro_torch.serve import (DispatchError, QueryService, QueueFull,
                               VirtualClock)
from repro_torch.serve import loadgen
from repro_torch.serve.mr import _synthesize_inputs

FAMILIES = ["sort", "multisearch", "hull2d", "hull3d", "lp", "prefix",
            "funnel"]


@pytest.fixture(autouse=True)
def jax_trace_state_clean(monkeypatch):
    """The JAX package's tracer calls ``jax.core.trace_state_clean``, which
    some jax releases keep only as ``jax._src.core.trace_state_clean``."""
    if not hasattr(jax.core, "trace_state_clean"):
        from jax._src import core as jax_src_core
        monkeypatch.setattr(jax.core, "trace_state_clean",
                            jax_src_core.trace_state_clean, raising=False)


def _plans(m):
    """The seven families at test-tiny sizes, built by either package."""
    add = jnp.add if m is J else torch.add
    return {
        "sort": m.sort_plan(32, 8),
        "multisearch": m.multisearch_plan(16, 8, 8),
        "hull2d": m.hull2d_plan(24, 8),
        "hull3d": m.hull3d_plan(8, 8),
        "lp": m.lp_plan(8, 2, 8),
        "prefix": m.prefix_plan(32, 8, physical=True),
        "funnel": m.funnel_write_plan(16, 8, 8, add, identity=0.0),
    }


def _sample(family, rng):
    if family == "sort":
        return (rng.normal(size=32).astype(np.float32),)
    if family == "multisearch":
        return (rng.normal(size=16).astype(np.float32),
                np.sort(rng.normal(size=8).astype(np.float32)))
    if family == "hull2d":
        return (rng.normal(size=(24, 2)).astype(np.float32),)
    if family == "hull3d":
        return (rng.normal(size=(8, 3)).astype(np.float32),)
    if family == "lp":
        return (np.array([1.0, 2.0], np.float32),
                rng.normal(size=(8, 2)).astype(np.float32),
                rng.uniform(1.0, 2.0, 8).astype(np.float32))
    if family == "prefix":
        return (rng.integers(0, 9, 32).astype(np.int32),)
    return (rng.integers(0, 8, 16).astype(np.int32),
            rng.normal(size=16).astype(np.float32), np.zeros(8, np.float32))


def _port_key(family, key, n):
    """The sample indices the JAX package draws from ``key`` for a
    ``family`` query over ``n`` items (None: the family draws nothing)."""
    if family in ("sort", "hull2d"):
        return np.asarray(jax.random.permutation(key, n))
    if family == "multisearch":
        return np.asarray(jax.random.randint(
            key, (n,), 0, min(max(n, 2) ** 3, 2 ** 31 - 1), dtype=jnp.int32))
    return None


def _leaves(tree):
    return [l.cpu().numpy() if isinstance(l, torch.Tensor) else np.asarray(l)
            for l in tree_leaves(tree)]


def assert_tree_equal(a, b, ctx=""):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), ctx
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype, ctx
        np.testing.assert_array_equal(x, y, err_msg=ctx)


def assert_matches_jax(want, got, family, ctx=""):
    """Every leaf bit for bit; the LP's x and objective within the LP
    tolerances of tests/test_torch_geometry.py (float32 basis solves)."""
    wl = [np.asarray(l) for l in jax.tree_util.tree_leaves(want)]
    gl = _leaves(got)
    assert len(wl) == len(gl), ctx
    for i, (g, w) in enumerate(zip(gl, wl)):
        assert g.dtype == w.dtype, ctx
        if family == "lp" and g.dtype == np.float32 and i < 2:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4,
                                       err_msg=ctx)
        else:
            np.testing.assert_array_equal(g, w, err_msg=ctx)


# ---------------------------------------------------------------------------
# Coalesced results: the JAX package's service, and sequential calls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_coalesced_matches_jax_service_and_sequential(family):
    """One full window of 3 and 2 stragglers flushed at the deadline: each
    result equals the JAX package's ``QueryService`` on the same queries
    and keys, and the port's own sequential calls."""
    B, extra = 3, 2
    rng = np.random.default_rng(FAMILIES.index(family))
    queries = [_sample(family, rng) for _ in range(B + extra)]
    keys = jax.random.split(jax.random.PRNGKey(11), B + extra)
    n = queries[0][0].shape[0]
    jplan = _plans(J)[family]
    jsvc = JS.QueryService(J.LocalEngine(), max_batch=B, max_wait_ms=5.0,
                           clock=JS.VirtualClock())
    jt = [jsvc.submit(jplan, *(jnp.asarray(a) for a in q), key=k)
          for q, k in zip(queries, keys)]
    jsvc.drain()
    plan = _plans(T)[family]
    for eng in (get_engine("kernel", device="cpu"), ReferenceEngine()):
        tkeys = [_port_key(family, k, n) for k in keys]
        exe = eng.compile(plan)
        seq = [exe(*q, key=k) for q, k in zip(queries, tkeys)]
        clock = VirtualClock()
        svc = QueryService(eng, max_batch=B, max_wait_ms=5.0, clock=clock)
        tickets = [svc.submit(plan, *q, key=k)
                   for q, k in zip(queries, tkeys)]
        assert all(t.done for t in tickets[:B])
        assert not any(t.done for t in tickets[B:])
        clock.advance(0.005)
        assert svc.step() == extra
        for i, (t, s, w) in enumerate(zip(tickets, seq, jt)):
            ctx = f"{family} {eng.name} query {i}"
            assert_tree_equal(t.value, s, ctx=ctx)
            assert_matches_jax(w.value, t.value, family, ctx=ctx)
            assert t.batch_occupancy == (B if i < B else extra)


def test_default_key_matches_sequential_default():
    """key=None resolves at submit to the plan's default seed, as a
    sequential ``exe(*inputs, key=None)``."""
    eng = LocalEngine(device="cpu")
    plan = T.sort_plan(32, 8)
    x = np.random.default_rng(0).normal(size=32).astype(np.float32)
    seq = eng.compile(plan)(x, key=None)
    svc = QueryService(eng, max_batch=2, clock=VirtualClock())
    t = svc.submit(plan, x)
    assert t.key == plan.default_seed
    svc.drain()
    assert_tree_equal(t.value, seq)


# ---------------------------------------------------------------------------
# Dispatch triggers and the driver loop
# ---------------------------------------------------------------------------

def _svc(B=4, wait_ms=5.0, engine=None, **kw):
    eng = engine or LocalEngine(device="cpu")
    clock = VirtualClock()
    svc = QueryService(eng, max_batch=B, max_wait_ms=wait_ms, clock=clock,
                       **kw)
    rng = np.random.default_rng(3)
    return svc, clock, T.sort_plan(32, 8), \
        lambda: rng.normal(size=32).astype(np.float32)


def test_window_full_dispatches_inside_submit():
    svc, _, plan, x = _svc(B=4)
    ts = [svc.submit(plan, x()) for _ in range(4)]
    assert all(t.done for t in ts)
    assert svc.dispatches == 1 and svc.pending == 0


def test_deadline_dispatches_partial_window_exactly():
    svc, clock, plan, x = _svc(B=4, wait_ms=5.0)
    t = svc.submit(plan, x())
    assert svc.step() == 0 and not t.done
    clock.advance(0.004999)
    assert svc.step() == 0               # still 1 us early
    clock.advance(0.000001)
    assert svc.step() == 1               # exactly at the deadline
    assert t.done and t.batch_occupancy == 1


def test_wait_drain_and_dispatch_oldest():
    svc, clock, plan, x = _svc(B=4)
    t = svc.submit(plan, x())
    assert t.wait() is t.value and t.done
    plan2 = T.sort_plan(64, 8)
    rng = np.random.default_rng(4)
    svc.submit(plan, x())
    svc.submit(plan2, rng.normal(size=64).astype(np.float32))
    assert svc.pending == 2 and svc.drain() == 2 and svc.pending == 0
    t_old = svc.submit(plan, x())
    clock.advance(0.001)
    t_new = svc.submit(plan2, rng.normal(size=64).astype(np.float32))
    assert svc.dispatch_oldest() == 1
    assert t_old.done and not t_new.done
    assert svc.dispatch_oldest() == 1 and svc.dispatch_oldest() == 0


def test_per_plan_deadline_override():
    svc, clock, plan, x = _svc(B=4, wait_ms=5.0)
    plan2 = T.sort_plan(64, 8)
    svc.register(plan, max_wait_ms=2.0)
    a = svc.submit(plan, x())
    b = svc.submit(plan2, np.zeros(64, np.float32))
    clock.advance(0.002)
    assert svc.step() == 1 and a.done and not b.done
    with pytest.raises(ValueError):
        svc.register(plan, max_wait_ms=-1.0)
    svc.register(plan)                   # clears the override
    c = svc.submit(plan, x(), max_wait_ms=1.0)
    clock.advance(0.001)
    assert svc.step() == 1 and c.done


# ---------------------------------------------------------------------------
# Admission control
# ---------------------------------------------------------------------------

def test_pending_budget_rejects_with_retry_hint():
    eng = LocalEngine(device="cpu")
    svc = QueryService(eng, max_batch=4, max_wait_ms=7.5, max_pending=4,
                       clock=VirtualClock())
    p1, p2 = T.sort_plan(32, 8), T.sort_plan(64, 8)
    rng = np.random.default_rng(5)
    for plan, n in ((p1, 32), (p2, 64), (p1, 32), (p2, 64)):
        svc.submit(plan, rng.normal(size=n).astype(np.float32))
    with pytest.raises(QueueFull) as ei:
        svc.submit(p1, rng.normal(size=32).astype(np.float32))
    assert ei.value.reason == "pending" and ei.value.retry_after_ms == 7.5
    assert svc.rejected == 1
    svc.dispatch_oldest()
    assert svc.submit(p1, rng.normal(size=32).astype(np.float32)) is not None


def test_cold_plan_thrash_guard():
    eng = LocalEngine(device="cpu")
    eng.cache_size = 1                   # before the first compile
    svc = QueryService(eng, max_batch=4, clock=VirtualClock())
    p1, p2 = T.sort_plan(32, 8), T.sort_plan(64, 8)
    svc.submit(p1, np.zeros(32, np.float32))
    with pytest.raises(QueueFull) as ei:
        svc.submit(p2, np.zeros(64, np.float32))
    assert ei.value.reason == "plan-cache"
    svc.drain()
    eng.compile(p2)
    assert not svc.submit(p2, np.zeros(64, np.float32)).done


def test_config_validation():
    eng = LocalEngine(device="cpu")
    with pytest.raises(ValueError, match="max_batch"):
        QueryService(eng, max_batch=0)
    with pytest.raises(ValueError, match="max_pending"):
        QueryService(eng, max_batch=8, max_pending=4)
    with pytest.raises(ValueError):
        QueryService(eng, max_retries=-1)
    with pytest.raises(ValueError):
        VirtualClock().advance(-1.0)


# ---------------------------------------------------------------------------
# Live rows only, and the JAX package's window accounting
# ---------------------------------------------------------------------------

def test_dispatch_runs_only_live_queries_and_accounts_windows():
    """A deadline dispatch of 3 queries at ``max_batch`` 16 on the
    batchable kernel engine runs the 3 live queries as one program (one
    run, 2 shuffles for the batch); on the fault proxy, which cannot batch,
    it runs all 16 lanes of the padded window one after another (16 runs,
    16 x 2 shuffle attempts), as the JAX package's loop does.  Either way
    ``pad_slots`` and ``stats()`` count the 13 empty lanes as the JAX
    package's service does."""
    plan = T.sort_plan(32, 8)
    jplan = J.sort_plan(32, 8)
    rng = np.random.default_rng(6)
    xs = [rng.normal(size=32).astype(np.float32) for _ in range(3)]
    jsvc = JS.QueryService(J.LocalEngine(), max_batch=16, max_wait_ms=5.0,
                           clock=JS.VirtualClock())
    for x in xs:
        jsvc.submit(jplan, jnp.asarray(x))
    jsvc.clock.advance(0.005)
    assert jsvc.step() == 3
    jst = jsvc.stats()
    kernel = get_engine("kernel", device="cpu")
    faulty = with_faults(get_engine("kernel", device="cpu"), FaultConfig())
    for eng, runs in ((kernel, 1), (faulty, 16)):
        svc = QueryService(eng, max_batch=16, max_wait_ms=5.0,
                           clock=VirtualClock())
        for x in xs:
            svc.submit(plan, x)
        svc.clock.advance(0.005)
        assert svc.step() == 3
        exe = eng.compile(plan)
        assert exe.trace_count == runs
        assert eng.route_log.kernel == runs * 2
        assert svc.pad_slots == 13 and svc.coalesced == 3
        st = svc.stats()
        for k in ("submitted", "completed", "rejected", "pending", "failed",
                  "requeued", "dispatches", "mean_occupancy", "pad_fraction",
                  "p50_latency_s", "p99_latency_s"):
            assert st[k] == jst[k], k
        assert st["traces"] == {"sort": runs}
        assert st["cache"]["misses"] == jst["cache"]["misses"] == 1
    assert faulty.injector.calls == 16 * 2


def test_warmup_compiles_and_runs_each_plan_once():
    eng = LocalEngine(device="cpu")
    clock = VirtualClock()
    svc = QueryService(eng, max_batch=3, clock=clock)
    plans = _plans(T)
    rng = np.random.default_rng(8)
    warm = svc.warmup([plans[f] for f in ("sort", "multisearch", "prefix")])
    names = [plans[f].name for f in ("sort", "multisearch", "prefix")]
    assert warm == dict.fromkeys(names, 1)
    misses = eng.cache_info().misses
    for _ in range(3):
        for f in ("sort", "multisearch", "prefix"):
            for _ in range(3):
                svc.submit(plans[f], *_sample(f, rng))
    clock.advance(0.005)
    svc.step()
    assert svc.pending == 0
    assert eng.cache_info().misses == misses        # no new compiles
    # runs: the warm-up's, then one batched program per dispatch of 3
    assert svc.trace_counts() == dict.fromkeys(names, 4)


def test_synthesized_inputs_match_jax_for_all_seven_families():
    jplans = _plans(J)
    from repro.serve.mr import _synthesize_inputs as jax_synthesize
    for family, plan in _plans(T).items():
        got, want = _synthesize_inputs(plan), jax_synthesize(jplans[family])
        assert len(got) == len(want) == len(plan.input_spec)
        for g, w in zip(got, want):
            assert g.dtype == torch.from_numpy(np.array(w)).dtype, family
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    svc = QueryService(LocalEngine(device="cpu"), max_batch=2,
                       clock=VirtualClock())
    assert svc.warmup([_plans(T)["funnel"]]) == {"funnel-write": 1}


def test_latency_and_queue_delay_are_exact():
    eng = LocalEngine(device="cpu")
    clock = VirtualClock(start=100.0)
    svc = QueryService(eng, max_batch=2, max_wait_ms=10.0, clock=clock)
    plan = T.sort_plan(32, 8)
    t1 = svc.submit(plan, np.zeros(32, np.float32))
    assert t1.latency is None and t1.queue_delay is None
    clock.advance(0.003)
    t2 = svc.submit(plan, np.ones(32, np.float32))
    assert t1.done and t2.done
    assert t1.submitted_at == 100.0
    assert t1.latency == pytest.approx(0.003) and t2.latency == 0.0
    assert t1.queue_delay == pytest.approx(0.003)
    st = svc.stats()
    assert st["completed"] == 2 and st["mean_occupancy"] == 2.0


# ---------------------------------------------------------------------------
# Dispatch failures: retry, typed errors, guaranteed drain
# ---------------------------------------------------------------------------

def _faulty(faults, B=4, **kw):
    return _svc(B=B, engine=with_faults(get_engine("kernel", device="cpu"),
                                        FaultConfig(**faults)), **kw)


def test_drain_terminates_under_persistent_faults():
    svc, _, plan, x = _faulty({"failure_probability": 1.0}, max_retries=2)
    ts = [svc.submit(plan, x()) for _ in range(3)]
    assert svc.drain() == 3 and svc.pending == 0
    assert all(t.done and t.failed for t in ts)
    assert all(isinstance(t.error, DispatchError) for t in ts)
    assert all(t.retries == 3 for t in ts)
    assert svc.failed == 3 and svc.completed == 0 and svc.requeued == 6
    s = svc.stats()
    assert s["failed"] == 3 and s["pending"] == 0


def test_transient_fault_requeues_then_succeeds():
    svc, _, plan, x = _faulty({"fail_at": (0,)})
    q = x()
    seq = LocalEngine(device="cpu").compile(plan)(q, key=None)
    t = svc.submit(plan, q)
    assert svc.drain() >= 1
    assert t.done and not t.failed and t.retries == 1
    assert svc.requeued == 1 and svc.failed == 0
    assert_tree_equal(t.value, seq)


def test_wait_raises_dispatch_error_with_cause():
    svc, _, plan, x = _faulty({"failure_probability": 1.0}, max_retries=1)
    t = svc.submit(plan, x())
    with pytest.raises(DispatchError) as ei:
        t.wait()
    assert isinstance(ei.value.__cause__, ShardFailure)
    assert ei.value.attempts == 2


def test_failed_batch_preserves_fifo_order():
    svc, _, plan, x = _faulty({"fail_at": (0,)}, B=2)
    t1 = svc.submit(plan, x())
    t2 = svc.submit(plan, x())           # window full -> dispatch -> fails
    assert not t1.done and svc.pending == 2
    q = svc._queues[svc.engine.plan_key(plan)]
    assert [t.uid for t in q] == [t1.uid, t2.uid]
    svc.drain()
    assert t1.done and t2.done and not t1.failed and not t2.failed


def test_step_terminates_with_failing_backlog():
    svc, _, plan, x = _faulty({"failure_probability": 1.0}, B=2,
                              max_retries=0)
    ts = [svc.submit(plan, x()) for _ in range(2)]
    assert all(t.failed for t in ts) and svc.step() == 0


# ---------------------------------------------------------------------------
# The load generator
# ---------------------------------------------------------------------------

def test_workload_draws_the_jax_package_families_and_inputs():
    cfg = loadgen.TrafficConfig(n_queries=40, seed=3)
    jwl = JL.make_workload(JL.make_suite(J.LocalEngine(), JL.TrafficConfig(
        n_queries=40, seed=3)), JL.TrafficConfig(n_queries=40, seed=3))
    wl = loadgen.make_workload(
        loadgen.make_suite(LocalEngine(device="cpu"), cfg), cfg)
    assert [q.family for q in wl] == [q.family for q in jwl]
    for q, jq in zip(wl, jwl):
        assert q.uid == jq.uid
        for a, b in zip(q.inputs, jq.inputs):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert len({q.key for q in wl}) == len(wl)
    again = loadgen.make_workload(
        loadgen.make_suite(LocalEngine(device="cpu"), cfg), cfg)
    assert [q.key for q in again] == [q.key for q in wl]
    with pytest.raises(ValueError, match="unknown traffic"):
        loadgen.make_suite(LocalEngine(device="cpu"),
                           loadgen.TrafficConfig(families=("sort", "nope")))


@pytest.mark.parametrize("process,qps,seed", [
    ("poisson", 800.0, 7), ("poisson", 200.0, 4),
    ("deterministic", 200.0, 0)])
def test_arrival_times_match_jax(process, qps, seed):
    got = loadgen.arrival_times(32, qps, process, seed=seed)
    np.testing.assert_array_equal(
        got, JL.arrival_times(32, qps, process, seed=seed))
    with pytest.raises(ValueError):
        loadgen.arrival_times(4, 100.0, "uniform")


DEMO = dict(n_queries=48, seed=7)     # the JAX package's obs demo traffic


def _open_loop(pkg, traced, faults=None):
    """The observability demo's serve run: Poisson arrivals at 800 qps on a
    virtual clock, ``max_batch`` 4, ``max_wait_ms`` 5 with a 2 ms sort
    tier."""
    m, lg, srv, obs = ((J, JL, JS, JO) if pkg == "jax"
                       else (T, loadgen, None, None))
    clock = (JS.VirtualClock() if pkg == "jax" else VirtualClock())
    tracer = None
    if traced:
        tracer = (JO.Tracer(clock=clock) if pkg == "jax"
                  else Tracer(clock=clock))
    eng = (J.LocalEngine(tracer=tracer) if pkg == "jax"
           else get_engine("kernel", device="cpu", tracer=tracer))
    if faults is not None:
        eng = with_faults(eng, FaultConfig(**faults))
    svc = (JS.QueryService if pkg == "jax" else QueryService)(
        eng, max_batch=4, max_wait_ms=5.0, max_retries=2, clock=clock)
    cfg = lg.TrafficConfig(**DEMO)
    suite = lg.make_suite(eng, cfg)
    workload = lg.make_workload(suite, cfg)
    svc.register(suite["sort"][0], max_wait_ms=2.0)
    row = lg.run_open_loop(svc, workload, offered_qps=800.0, clock=clock,
                           process="poisson", seed=cfg.seed)
    results = {t.uid - 1: t.value for t in svc.finished if not t.failed}
    return row, results, tracer, workload


def test_open_loop_row_matches_jax_on_the_demo_traffic():
    """Untraced, the row equals the JAX package's exactly; traced, the
    row's queueing figures and the service's metrics (submits, dispatches,
    completions, occupancy and wait histograms, plan-cache misses) too.
    Neither package's batched programs count rounds (``engine.rounds``);
    the port counts the route of every batched shuffle, the JAX package
    each route once, when it lowers a batch size."""
    jrow, _, _, _ = _open_loop("jax", False)
    row, _, _, _ = _open_loop("port", False)
    assert row == jrow
    jrow, _, _, _ = _open_loop("jax", True)
    row, _, _, _ = _open_loop("port", True)
    jm, m = jrow.pop("metrics"), row.pop("metrics")
    assert row == jrow
    assert m["histograms"] == jm["histograms"]
    assert m["gauges"] == jm["gauges"]
    assert {k: v for k, v in m["counters"].items()
            if not k.startswith("shuffle.")} == {
                k: v for k, v in jm["counters"].items()
                if not k.startswith("shuffle.")}
    assert "engine.rounds" not in m["counters"]
    assert m["counters"]["shuffle.route.kernel"] > 0


def test_demo_with_faults_recovers_traced_and_untraced():
    """The demo with shard failures at shuffle attempts 3 and 11: traced and
    untraced runs give the same results, equal to ``run_sequential`` on the
    dense engine; the trace counts both failures and keeps every stage's
    schedule.  (tests/test_torch_batch.py holds the attempts and the
    dispatches they fail to the JAX package's run.)"""
    faults = dict(fail_at=(3, 11), seed=7)
    row, traced, tr, workload = _open_loop("port", True, faults)
    row2, plain, _, _ = _open_loop("port", False, faults)
    assert row["accepted"] == 48 and row2 == {k: v for k, v in row.items()
                                             if k != "metrics"}
    loadgen.assert_results_equal(traced, plain, "tracing on vs off")
    seq, wall, lat = loadgen.run_sequential(LocalEngine(device="cpu"),
                                            workload)
    loadgen.assert_results_equal(traced, seq, "service vs sequential")
    assert len(lat) == 48 and wall >= 0
    s = summarize(tr)
    assert s["schedule_ok"]
    assert s["recovery"]["failures"] == 2
    assert s["serve"]["dispatch_errors"] == 2
    assert s["serve"]["completed"] == 48 and s["serve"]["failed"] == 0
    assert s["routes"]["dense"] == 0 and s["routes"]["kernel"] > 0


def test_closed_loop_matches_sequential():
    cfg = loadgen.TrafficConfig(n_queries=40, seed=1)
    eng = get_engine("kernel", device="cpu")
    suite = loadgen.make_suite(eng, cfg)
    wl = loadgen.make_workload(suite, cfg)
    svc = QueryService(eng, max_batch=8, max_pending=16, clock=VirtualClock())
    results, wall = loadgen.run_closed_loop(svc, wl, concurrency=12)
    seq, _, _ = loadgen.run_sequential(LocalEngine(device="cpu"), wl)
    loadgen.assert_results_equal(results, seq, "closed loop")
    st = svc.stats()
    assert st["completed"] == 40 and st["pending"] == 0 and wall >= 0
    u0, u1 = [q.uid for q in wl if q.family == "sort"][:2]
    bad = {**seq, u0: seq[u1]}
    with pytest.raises(AssertionError, match="diverged"):
        loadgen.assert_results_equal(results, bad, "x")

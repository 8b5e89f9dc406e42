"""Observability in the port (``repro_torch.obs`` and its hooks) against the
JAX package's ``repro.obs`` on the same inputs.

The contracts: a seeded query traced through the port records the JAX
package's event stream — the same kinds, attributes and (on a counting
clock) timestamps; ``summarize`` gives the JAX package's report on the
same trace; the exporters round-trip and render the JAX package's JSON;
and tracing leaves outputs and ``CostAccum`` unchanged, while the default
``NULL_TRACER`` never enters the traced code paths.  The JAX oracle runs
its plans eagerly (``LocalEngine(use_scan=False)``), where its tracer
records every round.
"""
import itertools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.core as J
import repro.obs as JO
from repro.core import recovery as JR
from repro_torch._tree import tree_leaves
from repro_torch.core import (LocalEngine, ReferenceEngine, execute_plan,
                              get_engine, hull2d_plan, sort_plan)
from repro_torch.core import plan as port_plan
from repro_torch.core.recovery import (Checkpointer, FaultConfig,
                                       FaultInjector, run_plan_with_recovery,
                                       with_faults)
from repro_torch.obs import (NULL_TRACER, MetricsRegistry, TraceEvent,
                             Tracer, diff_summaries, format_diff,
                             format_table, plan_token, read_jsonl,
                             summarize, to_chrome_trace, write_chrome_trace,
                             write_jsonl)
from repro_torch.obs import trace as port_trace


@pytest.fixture(autouse=True)
def jax_trace_state_clean(monkeypatch):
    """The JAX package's tracer calls ``jax.core.trace_state_clean``, which
    some jax releases keep only as ``jax._src.core.trace_state_clean``."""
    if not hasattr(jax.core, "trace_state_clean"):
        from jax._src import core as jax_src_core
        monkeypatch.setattr(jax.core, "trace_state_clean",
                            jax_src_core.trace_state_clean, raising=False)


def _counting_clock():
    return itertools.count(0.0, 0.25).__next__


def _query(kind, seed):
    """(JAX plan, port plan, numpy input, JAX key, the port's key)."""
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    if kind == "sort":
        n, M = 300, 16
        x = rng.normal(size=n).astype(np.float32)
        return (J.sort_plan(n, M), sort_plan(n, M), x, key,
                np.asarray(jax.random.permutation(key, n)))
    n, M = 200, 16
    pts = rng.normal(size=(n, 2)).astype(np.float32)
    return (J.hull2d_plan(n, M), hull2d_plan(n, M), pts, key,
            np.asarray(jax.random.permutation(key, n)))


def _traced_pair(kind, seed):
    """The query traced through both packages' eager dense engines on
    counting clocks; returns (JAX tracer, port tracer, JAX out, port out)."""
    jp, tp, x, jkey, tkey = _query(kind, seed)
    jtr, ttr = JO.Tracer(clock=_counting_clock()), \
        Tracer(clock=_counting_clock())
    jout = J.execute_plan(jp, J.LocalEngine(use_scan=False, tracer=jtr),
                          (jnp.asarray(x),), key=jkey)
    tout = execute_plan(tp, LocalEngine(device="cpu", tracer=ttr), (x,),
                        key=tkey)
    return jtr, ttr, jout, tout


def _leaves(tree):
    return [l.cpu().numpy() if isinstance(l, torch.Tensor) else np.asarray(l)
            for l in tree_leaves(tree)]


def assert_tree_equal(a, b, ctx=""):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), ctx
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype, ctx
        np.testing.assert_array_equal(x, y, err_msg=ctx)


# ---------------------------------------------------------------------------
# The port's trace of a query is the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,seed", [("sort", 0), ("sort", 3),
                                       ("hull2d", 1), ("hull2d", 4)])
def test_signatures_match_jax(kind, seed):
    """Kinds and attributes (plan digest, stage, declared schedule,
    measured rounds, items sent, drops, every round's stats) of every
    event equal the JAX package's; on counting clocks the timestamps and
    durations too."""
    jtr, ttr, jout, tout = _traced_pair(kind, seed)
    assert ttr.signatures() == jtr.signatures()
    assert [e.to_dict() for e in ttr.events()] == \
        [e.to_dict() for e in jtr.events()]
    assert [e.kind for e in ttr.events()][-1] == "plan.execute"
    assert ttr.metrics.snapshot() == jtr.metrics.snapshot()
    want = [np.asarray(l) for l in jax.tree_util.tree_leaves(jout)]
    got = _leaves(tout)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind,seed", [("sort", 0), ("hull2d", 1)])
def test_summary_matches_jax(kind, seed):
    """``summarize`` of the port's trace equals the JAX package's summary
    of its own, and the port's ``summarize`` of the JAX trace too."""
    jtr, ttr, _, _ = _traced_pair(kind, seed)
    want = JO.summarize(jtr)
    assert summarize(ttr) == want
    assert summarize([TraceEvent.from_dict(e.to_dict())
                      for e in jtr.events()]) == want
    assert want["schedule_ok"] and want["totals"]["rounds"] > 0
    assert format_table(summarize(ttr)) == JO.format_table(want)
    rows = diff_summaries(summarize(ttr), want)
    assert rows == JO.diff_summaries(want, want)
    assert format_diff(rows) == JO.format_diff(rows)
    assert not any(r["drift"] for r in rows)


def test_kernel_engine_trace_adds_one_route_event_a_shuffle():
    """On the kernel engine the trace is the dense engine's plus one
    ``shuffle.route`` event a shuffle, all ``kernel``, and the route
    counter the JAX package keeps in the metrics."""
    _, tp, x, _, tkey = _query("sort", 0)
    dense, kern = Tracer(), Tracer()
    execute_plan(tp, LocalEngine(device="cpu", tracer=dense), (x,), key=tkey)
    eng = get_engine("kernel", device="cpu", tracer=kern)
    execute_plan(tp, eng, (x,), key=tkey)
    routes = [e for e in kern.events() if e.kind == "shuffle.route"]
    assert len(routes) == eng.route_log.kernel == 2
    assert {e.attrs["impl"] for e in routes} == {"kernel"}

    def strip(sigs):
        return [(k, tuple((a, "-" if a == "backend" else v) for a, v in attrs))
                for k, attrs in sigs if k != "shuffle.route"]

    assert strip(kern.signatures()) == strip(dense.signatures())
    assert kern.metrics.snapshot()["counters"]["shuffle.route.kernel"] == 2
    assert summarize(kern)["routes"] == {"kernel": 2, "dense": 0}


@pytest.mark.parametrize("engine", ["local", "kernel", "reference"])
@pytest.mark.parametrize("kind", ["sort", "hull2d"])
def test_tracing_leaves_results_unchanged(kind, engine):
    _, tp, x, _, tkey = _query(kind, 2)

    def make(tr=None):
        if engine == "reference":
            return ReferenceEngine(tracer=tr)
        return get_engine(engine, device="cpu", tracer=tr)

    plain = make().compile(tp)(x, key=tkey)
    tr = Tracer()
    traced = make(tr).compile(tp)(x, key=tkey)
    assert_tree_equal(plain, traced, ctx=f"{kind} {engine}")
    s = summarize(tr)
    assert s["schedule_ok"] and s["cache"]["exe_calls"] == 1
    assert s["cache"]["misses"] == 1 and s["cache"]["compiles"] == 0
    assert s["totals"]["rounds"] == int(traced.stats.rounds)


def test_null_tracer_never_enters_the_traced_paths(monkeypatch):
    """With the default ``NULL_TRACER`` no span, round event or measured
    delta is taken: the traced stage loop and ``round_event`` (the only
    places that read device values back for the trace) never run."""
    def boom(*a, **k):
        raise AssertionError("traced path entered without a tracer")

    monkeypatch.setattr(port_plan, "_traced_apply", boom)
    monkeypatch.setattr(port_plan, "_round_event", boom)
    import repro_torch.core.engine as port_engine
    monkeypatch.setattr(port_engine, "_round_event", boom)
    monkeypatch.setattr(port_trace, "_host_value", boom)
    for kind in ("sort", "hull2d"):
        _, tp, x, _, tkey = _query(kind, 0)
        eng = get_engine("kernel", device="cpu")
        assert eng.tracer is NULL_TRACER
        eng.compile(tp)(x, key=tkey)
        execute_plan(tp, eng, (x,), key=tkey)
        eng.compile(tp).batch(2)(np.stack([x, x]), keys=[tkey, tkey])


def test_exe_call_events_match_jax_eager_executable():
    """``Executable.__call__`` records ``exe.call`` and counts
    ``exe.calls``; the port never records ``exe.compile``.  A batch on the
    batchable ``LocalEngine`` is one round program and records no
    per-query span, as the JAX package's ``jit`` of a ``vmap`` records
    none; on a non-batchable engine its rows record as single calls but
    without ``exe.call`` (the JAX package's loop)."""
    _, tp, x, _, tkey = _query("sort", 0)
    tr = Tracer()
    eng = LocalEngine(device="cpu", tracer=tr)
    exe = eng.compile(tp)
    exe(x, key=tkey)
    exe(x, key=tkey)
    exe.batch(3)(np.stack([x] * 3), keys=[tkey] * 3)
    kinds = [e.kind for e in tr.events()]
    assert kinds.count("exe.call") == 2
    assert kinds.count("plan.execute") == 2
    assert "exe.compile" not in kinds
    rtr = Tracer()
    ReferenceEngine(tracer=rtr).compile(tp).batch(3)(np.stack([x] * 3),
                                                      keys=[tkey] * 3)
    rkinds = [e.kind for e in rtr.events()]
    assert rkinds.count("plan.execute") == 3
    assert rkinds.count("exe.call") == 0
    assert tr.metrics.snapshot()["counters"]["exe.calls"] == 2
    assert tr.metrics.snapshot()["counters"]["plan_cache.misses"] == 1
    call = [e for e in tr.events() if e.kind == "exe.call"][0]
    assert call.attrs == {"plan": "sort", "backend": "local"}
    assert call.dur is not None and call.dur >= 0


# ---------------------------------------------------------------------------
# The tracer core and the registry
# ---------------------------------------------------------------------------

def test_ring_bound_and_overwritten():
    for tr in (Tracer(maxlen=4, clock=iter(range(100)).__next__),
               JO.Tracer(maxlen=4, clock=iter(range(100)).__next__)):
        for i in range(10):
            tr.event("k", i=i)
        assert len(tr) == 4 and tr.recorded == 10 and tr.overwritten == 6
        assert [e.attrs["i"] for e in tr.events()] == [6, 7, 8, 9]
    with pytest.raises(ValueError):
        Tracer(maxlen=0)


def test_span_context_inheritance_and_abort():
    tr = Tracer(clock=iter(range(100)).__next__)
    with tr.span("plan.execute", plan="p", digest="d"):
        with tr.span("plan.stage", stage="s") as sp:
            tr.event("engine.round", round=0)
            sp["measured_rounds"] = 1
    with pytest.raises(RuntimeError):
        with tr.span("plan.stage", stage="t"):
            raise RuntimeError("killed")
    evs = tr.events()
    assert [e.kind for e in evs] == ["engine.round", "plan.stage",
                                     "plan.execute", "plan.stage"]
    assert evs[0].attrs == {"round": 0, "plan": "p", "stage": "s",
                            "digest": "d"}
    assert evs[1].attrs["measured_rounds"] == 1 and evs[1].dur == 2
    assert evs[3].attrs["aborted"] is True


def test_host_values_of_tensors_and_arrays():
    tr = Tracer(clock=iter(range(100)).__next__)
    tr.event("k", t=torch.tensor(3, dtype=torch.int32),
             f=torch.tensor(0.5), a=np.int32(7), arr=torch.zeros(2, 3),
             dev=torch.device("cpu"), none=None)
    attrs = tr.events()[0].attrs
    assert attrs == {"t": 3, "f": 0.5, "a": 7, "arr": "<array(2, 3)>",
                     "dev": "cpu", "none": None}
    assert type(attrs["t"]) is int and type(attrs["a"]) is int


def test_null_tracer_is_inert():
    assert not NULL_TRACER.enabled
    NULL_TRACER.event("x", a=1)
    NULL_TRACER.count("c")
    NULL_TRACER.observe("h", 1.0)
    with NULL_TRACER.span("s", k=1) as sp:
        sp["ignored"] = 2
    assert len(NULL_TRACER) == 0 and NULL_TRACER.events() == []
    assert NULL_TRACER.signatures() == [] and NULL_TRACER.overwritten == 0
    assert NULL_TRACER.metrics.snapshot()["counters"] == {}


def test_metrics_snapshot_matches_jax():
    regs = (MetricsRegistry(), JO.MetricsRegistry())
    for reg in regs:
        reg.counter("serve.dispatches").inc()
        reg.counter("serve.completed").inc(3)
        reg.gauge("serve.pending").set(3)
        for v in (1.0, 2.0, 3.0, 4.0, 10.0):
            reg.histogram("serve.wait_ms").observe(v)
    assert regs[0].snapshot() == regs[1].snapshot()
    with pytest.raises(ValueError):
        regs[0].counter("c").inc(-1)
    regs[0].clear()
    assert regs[0].snapshot() == {"counters": {}, "gauges": {},
                                  "histograms": {}}


def test_plan_token_matches_jax():
    for jp, tp in ((J.sort_plan(4096, 64), sort_plan(4096, 64)),
                   (J.hull2d_plan(200, 16), hull2d_plan(200, 16))):
        assert plan_token(tp) == JO.plan_token(jp)


# ---------------------------------------------------------------------------
# Exporters
# ---------------------------------------------------------------------------

def test_exporters_round_trip_and_match_jax(tmp_path):
    jtr, ttr, _, _ = _traced_pair("sort", 0)
    n = write_jsonl(ttr, tmp_path / "t.jsonl")
    back = read_jsonl(tmp_path / "t.jsonl")
    assert n == len(back) == len(ttr)
    assert [e.signature() for e in back] == ttr.signatures()
    assert [(e.ts, e.dur) for e in back] == \
        [(e.ts, e.dur) for e in ttr.events()]
    JO.write_jsonl(jtr, tmp_path / "j.jsonl")
    assert (tmp_path / "t.jsonl").read_text() == \
        (tmp_path / "j.jsonl").read_text()
    doc = to_chrome_trace(ttr)
    assert json.dumps(doc) == json.dumps(JO.to_chrome_trace(jtr))
    m = write_chrome_trace(ttr, tmp_path / "t.json")
    loaded = json.loads((tmp_path / "t.json").read_text())
    assert loaded == json.loads(json.dumps(doc))
    assert m == sum(1 for r in loaded["traceEvents"] if r["ph"] != "M")
    assert {r["args"]["name"] for r in loaded["traceEvents"]
            if r["ph"] == "M"} == {"engine", "plan"}
    assert summarize(back) == summarize(ttr)


# ---------------------------------------------------------------------------
# Recovery in the trace
# ---------------------------------------------------------------------------

def _recovery_run(tmp, pkg):
    """One traced, faulted, checkpointed sort on each package's reference
    engine, the same plan, inputs and draw."""
    _, tp, x, jkey, tkey = _query("sort", 5)
    if pkg == "jax":
        tr = JO.Tracer(clock=_counting_clock())
        eng = J.ReferenceEngine(tracer=tr)
        plan = J.sort_plan(300, 16)
        ck = JR.Checkpointer(tmp, plan=plan, every=1)
        out, rep = JR.run_plan_with_recovery(
            plan, eng, (jnp.asarray(x),), key=jkey,
            faults=JR.FaultConfig(fail_at=(1,)), checkpointer=ck)
    else:
        tr = Tracer(clock=_counting_clock())
        eng = ReferenceEngine(tracer=tr)
        ck = Checkpointer(tmp, plan=tp, every=1)
        out, rep = run_plan_with_recovery(
            tp, eng, (x,), key=tkey, faults=FaultConfig(fail_at=(1,)),
            checkpointer=ck)
    return tr, out, rep


def test_recovery_trace_matches_jax(tmp_path):
    """The faulted run's events — the fault, the aborted stage, the
    checkpoint saves with their bytes, the restore, the restart — and its
    summary equal the JAX package's."""
    jtr, jout, jrep = _recovery_run(tmp_path / "j", "jax")
    ttr, tout, trep = _recovery_run(tmp_path / "t", "port")
    assert ttr.signatures() == jtr.signatures()
    s = summarize(ttr)
    assert s == JO.summarize(jtr)
    assert s["schedule_ok"]
    assert s["recovery"] == {"failures": 1, "stragglers": 0,
                             "ckpt_saves": trep.checkpoints_written,
                             "ckpt_bytes": trep.checkpoint_bytes,
                             "restores": 1, "restarts": 1,
                             "aborted_stages": 1}
    kinds = {e.kind for e in ttr.events()}
    assert {"fault.failure", "ckpt.save", "ckpt.restore", "recover.restart",
            "plan.stage", "engine.round"} <= kinds
    assert ttr.metrics.snapshot() == jtr.metrics.snapshot()
    again, _, _ = _recovery_run(tmp_path / "t2", "port")
    assert again.signatures() == ttr.signatures()


def test_injector_mirrors_into_engine_tracer():
    tr = Tracer()
    inj = FaultInjector(FaultConfig(fail_at=(0,)))
    eng = with_faults(LocalEngine(device="cpu", tracer=tr), inj)
    with pytest.raises(Exception):
        eng.shuffle(np.zeros(4, np.int32), np.arange(4.0), 4, 2)
    eng.shuffle(np.zeros(4, np.int32), np.arange(4.0), 4, 2)
    assert inj.events == [("failure", 0, 0)]
    assert [e.kind for e in tr.events()] == ["fault.failure"]
    assert tr.metrics.snapshot()["counters"]["fault.failures"] == 1

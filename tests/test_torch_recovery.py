"""Fault injection, round-boundary checkpoints and recovery in the port
(``repro_torch.core.recovery``) against the JAX package's
``repro.core.recovery`` on the same numpy inputs.

The contract: a plan killed by an injected shard failure and recovered
from its last round-boundary checkpoint returns outputs and a ``CostAccum``
equal bit for bit to the JAX package's fault-free run (the LP's float
basis solves within the tolerances of ``tests/test_torch_geometry.py``);
the injector fires at the same shuffle attempts as the JAX one; and every
checkpoint holds the JAX package's leaves, in its order, in its files.
The random draws are the JAX package's own, handed to the port as sample
indices (``jax.random.permutation`` for the splitters,
``jax.random.randint`` for the multisearch batches).
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.core as J
import repro_torch.core as T
from repro.core import recovery as JR
from repro_torch._tree import tree_leaves
from repro_torch.core import (LocalEngine, ReferenceEngine, execute_plan,
                              funnel_write_plan, get_engine)
from repro_torch.core.mrmodel import Mailbox
from repro_torch.core.recovery import (Checkpointer, FaultConfig,
                                       FaultInjector, FaultInjectingEngine,
                                       RecoveryReport, ShardFailure,
                                       elastic_engine, plan_digest,
                                       realign_mailbox, resume_plan,
                                       run_plan_with_recovery, with_faults)
from repro_torch.obs import plan_token

# The LP's basis solves are float32 linear algebra in both packages, held
# within the tolerances of tests/test_torch_geometry.py.
LP_OBJ_RTOL = 1e-5
LP_X_ATOL = 1e-4


@pytest.fixture(autouse=True)
def jax_trace_state_clean(monkeypatch):
    """The JAX package's tracer calls ``jax.core.trace_state_clean``, which
    some jax releases keep only as ``jax._src.core.trace_state_clean``."""
    if not hasattr(jax.core, "trace_state_clean"):
        from jax._src import core as jax_src_core
        monkeypatch.setattr(jax.core, "trace_state_clean",
                            jax_src_core.trace_state_clean, raising=False)


def _families(seed=11):
    """The seven plan families at test-tiny sizes: (builder taking the
    package's core module, numpy inputs, the port's key for the JAX
    package's default key)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=32).astype(np.float32)
    q = rng.normal(size=16).astype(np.float32)
    piv = np.sort(rng.normal(size=8).astype(np.float32))
    p2 = rng.normal(size=(24, 2)).astype(np.float32)
    p3 = rng.normal(size=(8, 3)).astype(np.float32)
    c = np.array([1.0, 2.0], np.float32)
    A = rng.normal(size=(8, 2)).astype(np.float32)
    b = rng.uniform(1.0, 2.0, 8).astype(np.float32)
    pv = rng.integers(0, 9, 32).astype(np.int32)
    addrs = rng.integers(0, 8, 16).astype(np.int32)
    vals = rng.normal(size=16).astype(np.float32)
    mem = np.zeros(8, np.float32)
    k7, k0 = jax.random.PRNGKey(7), jax.random.PRNGKey(0)
    return {
        "sort": (lambda m: m.sort_plan(32, 8), (x,),
                 np.asarray(jax.random.permutation(k7, 32))),
        "multisearch": (lambda m: m.multisearch_plan(16, 8, 8), (q, piv),
                        np.asarray(jax.random.randint(
                            k0, (16,), 0, 16 ** 3, dtype=jnp.int32))),
        "hull2d": (lambda m: m.hull2d_plan(24, 8), (p2,),
                   np.asarray(jax.random.permutation(k7, 24))),
        "hull3d": (lambda m: m.hull3d_plan(8, 8), (p3,), None),
        "lp": (lambda m: m.lp_plan(8, 2, 8), (c, A, b), None),
        "prefix": (lambda m: m.prefix_plan(32, 8, physical=True), (pv,),
                   None),
        "funnel": (lambda m: m.funnel_write_plan(
            16, 8, 8, jnp.add if m is J else torch.add, identity=0.0),
            (addrs, vals, mem), None),
    }


FAMILIES = list(_families())


def _port(family):
    mk, inputs, key = _families()[family]
    return mk(T), inputs, key


def _jax_run(family, checkpointer=None):
    mk, inputs, _ = _families()[family]
    plan = mk(J)
    out = J.execute_plan(plan, J.ReferenceEngine(),
                         tuple(jnp.asarray(a) for a in inputs),
                         checkpointer=checkpointer)
    return plan, out


def _leaves(tree):
    return [l.cpu().numpy() if isinstance(l, torch.Tensor) else np.asarray(l)
            for l in tree_leaves(tree)]


def assert_tree_equal(a, b, ctx=""):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), ctx
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype, ctx
        np.testing.assert_array_equal(x, y, err_msg=ctx)


def assert_matches_jax(family, want, got, ctx=""):
    """The port's plan output against the JAX package's: every leaf equal
    bit for bit (the LP's x and objective within the LP tolerances)."""
    wl = [np.asarray(l) for l in jax.tree_util.tree_leaves(want)]
    gl = _leaves(got)
    assert len(wl) == len(gl), ctx
    fuzzy = set()
    if family == "lp":
        fuzzy = {id(got.x), id(got.objective)}
        np.testing.assert_allclose(got.x.cpu().numpy(), np.asarray(want.x),
                                   atol=LP_X_ATOL, err_msg=ctx)
        w = float(want.objective)
        assert abs(float(got.objective) - w) <= LP_OBJ_RTOL * max(1.0, abs(w))
    for leaf, x, y in zip(tree_leaves(got), gl, wl):
        assert x.dtype == y.dtype, f"{ctx}: {x.dtype} vs {y.dtype}"
        if id(leaf) not in fuzzy:
            np.testing.assert_array_equal(x, y, err_msg=ctx)


def _count_shuffles(plan, engine, inputs, key):
    probe = with_faults(engine, FaultConfig())
    execute_plan(plan, probe, inputs, key=key)
    return probe.injector.calls


# ---------------------------------------------------------------------------
# Plan digests: the port's checkpoint directories are the JAX package's
# ---------------------------------------------------------------------------

DIGEST_CASES = {
    "sort": lambda m: m.sort_plan(4096, 64),
    "sort-levels2": lambda m: m.sort_plan(4096, 16, levels=2),
    "sort-trivial": lambda m: m.sort_plan(1, 64),
    "sort-int32": lambda m: m.sort_plan(500, 16, dtype="int32"),
    "multisearch": lambda m: m.multisearch_plan(32, 8, 8),
    "multisearch-flat": lambda m: m.multisearch_plan(40, 9, 4, shape=False),
    "prefix": lambda m: m.prefix_plan(64, 8),
    "prefix-exclusive-f32": lambda m: m.prefix_plan(
        50, 4, dtype="float32", inclusive=False),
    "prefix-physical": lambda m: m.prefix_plan(64, 8, physical=True),
    "hull2d": lambda m: m.hull2d_plan(64, 8),
    "hull2d-trivial": lambda m: m.hull2d_plan(0, 8),
    "hull3d": lambda m: m.hull3d_plan(8, 8),
    "lp": lambda m: m.lp_plan(8, 2, 8),
}


@pytest.mark.parametrize("case", list(DIGEST_CASES))
def test_plan_digest_matches_jax(case):
    """Every builder's ``(fingerprint, shape_fingerprint)`` repr, and so
    ``plan_digest`` and ``plan_token``, equal the JAX package's (dtypes
    named as numpy names them)."""
    jp, tp = DIGEST_CASES[case](J), DIGEST_CASES[case](T)
    assert repr((tp.fingerprint, tp.shape_fingerprint)) == \
        repr((jp.fingerprint, jp.shape_fingerprint))
    assert plan_digest(tp) == JR.plan_digest(jp)
    assert plan_token(tp) == plan_digest(tp)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_funnel_and_bsp_fingerprints_name_dtypes_as_jax(dtype):
    """The funnel's and BSP's fingerprints hold the caller's callables (the
    semigroup, the superstep), whose reprs differ between packages; every
    other field equals the JAX package's."""
    jp = J.funnel_write_plan(16, 8, 8, jnp.add, identity=0, dtype=dtype)
    tp = funnel_write_plan(16, 8, 8, torch.add, identity=0, dtype=dtype)
    assert tp.fingerprint[:4] + tp.fingerprint[5:] == \
        jp.fingerprint[:4] + jp.fingerprint[5:]
    assert tp.shape_fingerprint == jp.shape_fingerprint
    from repro_torch.core import BSPProgram, bsp_plan
    step = lambda t, ids, s, box, ok: (s, ids[:, None], s[:, None])
    tmpl = np.zeros((), dtype)
    jb = J.bsp_plan(J.BSPProgram(step), 2, 4, 8, jnp.asarray(tmpl))
    tb = bsp_plan(BSPProgram(step), 2, 4, 8, torch.from_numpy(tmpl))
    assert tb.fingerprint[-1] == jb.fingerprint[-1] == ((dtype, ()),)
    assert tb.fingerprint[2:5] == jb.fingerprint[2:5]


# ---------------------------------------------------------------------------
# The injector
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    FaultConfig(failure_probability=0.3, straggler_probability=0.3, seed=4,
                max_failures=100),
    FaultConfig(failure_probability=0.05, straggler_probability=0.5, seed=9),
    FaultConfig(fail_at=(0, 3, 7), fail_shard=5, straggler_probability=0.2),
    FaultConfig(failure_probability=1.0, max_failures=2),
], ids=["mixed", "stragglers", "fail-at", "budget"])
@pytest.mark.parametrize("n_shards", [1, 4])
def test_injector_events_match_jax(cfg, n_shards):
    """The same config fires the same failures and stragglers at the same
    (attempt, shard) as the JAX package's injector."""
    jcfg = JR.FaultConfig(**vars(cfg))
    logs = []
    for inj, err in ((FaultInjector(cfg), ShardFailure),
                     (JR.FaultInjector(jcfg), JR.ShardFailure)):
        fired = []
        for _ in range(40):
            try:
                inj.on_shuffle(n_shards)
            except err as e:
                fired.append((e.round_index, e.shard))
        logs.append((inj.events, fired, inj.calls, inj.failures,
                     inj.stragglers, inj.simulated_delay_s))
    assert logs[0] == logs[1]
    assert logs[0][0]


def test_replay_gets_fresh_draws_and_budget():
    inj = FaultInjector(FaultConfig(fail_at=(0,)))
    with pytest.raises(ShardFailure):
        inj.on_shuffle(1)
    inj.on_shuffle(1)                   # replay: attempt 1, no fault
    assert inj.calls == 2 and inj.failures == 1


def test_stragglers_never_change_results():
    eng = get_engine("kernel", device="cpu")
    plan, inputs, key = _port("sort")
    ref = execute_plan(plan, eng, inputs, key=key)
    faulty = with_faults(eng, FaultConfig(straggler_probability=1.0))
    assert_tree_equal(ref, execute_plan(plan, faulty, inputs, key=key))
    assert faulty.injector.stragglers == faulty.injector.calls > 0
    assert faulty.injector.simulated_delay_s > 0


def test_proxy_adopts_class_level_attrs_and_delegates():
    """``device``, ``cache_size`` and ``tracer`` are class attributes of
    MREngine, so the proxy adopts them; the rest delegates."""
    from repro_torch.obs import Tracer
    tr = Tracer()
    eng = get_engine("kernel", device="cpu", tracer=tr)
    eng.cache_size = 3
    proxy = with_faults(eng, FaultConfig())
    assert isinstance(proxy, FaultInjectingEngine)
    assert proxy.device == eng.device
    assert proxy.cache_size == 3
    assert proxy.tracer is tr and proxy.injector.tracer is tr
    assert proxy.name == "faulty-kernel"
    assert proxy.shuffle_impl == "kernel"
    assert proxy.route_log is eng.route_log
    assert proxy.aligned_nodes(3) == eng.aligned_nodes(3)
    assert proxy.node_ids(4).tolist() == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# Checkpoints hold the JAX package's leaves
# ---------------------------------------------------------------------------

def _manifest(ck, r):
    return json.loads((ck.root / f"step_{r:08d}" / "manifest.json")
                      .read_text())


@pytest.mark.parametrize("family", FAMILIES)
def test_checkpoint_leaves_match_jax(family, tmp_path):
    """Per round, the checkpoint's ``leaf_%05d`` files — the CostAccum, the
    mailbox and the plan carry, in the JAX package's leaf order — equal the
    ``.npy`` files the JAX package's Checkpointer writes, under the same
    ``plan_<digest>`` directory name and ``leaf_kinds``."""
    jck = JR.Checkpointer(tmp_path / "jax", plan=_families()[family][0](J),
                          every=1)
    jplan, _ = _jax_run(family, checkpointer=jck)
    plan, inputs, key = _port(family)
    ck = Checkpointer(tmp_path / "port", plan=plan, every=1)
    execute_plan(plan, get_engine("kernel", device="cpu"), inputs, key=key,
                 checkpointer=ck)
    if family != "funnel":           # its digest holds the semigroup's repr
        assert ck.root.name == jck.root.name
    assert ck.rounds() == jck.rounds() and ck.rounds()
    for r in ck.rounds():
        jm, tm = _manifest(jck, r), _manifest(ck, r)
        assert tm["meta"]["leaf_kinds"] == jm["meta"]["leaf_kinds"]
        for k in ("stage_index", "plan", "rounds_done"):
            assert tm["meta"][k] == jm["meta"][k]
        assert sorted(tm["tensors"]) == sorted(jm["tensors"])
        tree, _ = ck.load(r, device="cpu")
        assert list(tree) == ["accum", "box", "carry"]
        n_head = len(tree_leaves(tree["accum"])) + len(tree_leaves(
            tree["box"]))
        for i, name in enumerate(sorted(jm["tensors"])):
            assert tm["tensors"][name]["file"] == jm["tensors"][name]["file"]
            a = np.load(jck.root / f"step_{r:08d}" / jm["tensors"][name]
                        ["file"])
            b = np.load(ck.root / f"step_{r:08d}" / tm["tensors"][name]
                        ["file"])
            assert a.dtype == b.dtype and a.shape == b.shape, (r, name)
            if family == "lp" and i >= n_head and a.dtype == np.float32:
                # the carry's per-basis objectives and vertices
                np.testing.assert_allclose(b, a, rtol=LP_OBJ_RTOL,
                                           atol=LP_X_ATOL)
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"{r} {name}")


# ---------------------------------------------------------------------------
# Recovered runs equal the JAX package's fault-free run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine_name", ["reference", "local", "kernel"])
@pytest.mark.parametrize("family", FAMILIES)
def test_recovered_matches_jax_fault_free(family, engine_name, tmp_path):
    """A shard failure halfway through, recovered from the last
    round-boundary checkpoint: outputs and CostAccum equal the JAX
    package's fault-free run, and the port's own fault-free run bit for
    bit."""
    _, want = _jax_run(family)
    engine = (ReferenceEngine() if engine_name == "reference"
              else get_engine(engine_name, device="cpu"))
    plan, inputs, key = _port(family)
    ref = execute_plan(plan, engine, inputs, key=key)
    n = _count_shuffles(plan, engine, inputs, key)
    assert n >= 1
    ck = Checkpointer(tmp_path, plan=plan, every=1)
    out, rep = run_plan_with_recovery(
        plan, engine, inputs, key=key,
        faults=FaultConfig(fail_at=(n // 2,)), checkpointer=ck)
    assert rep.failures_injected == 1 and rep.restarts == 1
    assert rep.checkpoint_bytes == ck.bytes_written > 0
    assert_tree_equal(ref, out, ctx=f"{engine_name}:{family}")
    assert_matches_jax(family, want, out, ctx=f"{engine_name}:{family}")
    if engine_name == "kernel":
        assert engine.route_log.dense == 0 and engine.route_log.kernel > 0


@pytest.mark.parametrize("family", ["sort", "hull2d", "multisearch"])
def test_recovery_report_matches_jax(family, tmp_path):
    """The same fault on the same schedule: the JAX package's recovery and
    the port's report the same restarts, replayed rounds and checkpoints,
    and their outputs agree."""
    mk, inputs, key = _families()[family]
    jplan = mk(J)
    jeng = J.ReferenceEngine()
    jin = tuple(jnp.asarray(a) for a in inputs)
    jprobe = JR.with_faults(jeng, JR.FaultConfig())
    J.execute_plan(jplan, jprobe, jin)
    n = jprobe.injector.calls
    plan = mk(T)
    reports = []
    for every in (1, 2):
        jck = JR.Checkpointer(tmp_path / f"j{every}", plan=jplan,
                              every=every)
        want, jrep = JR.run_plan_with_recovery(
            jplan, jeng, jin, faults=JR.FaultConfig(fail_at=(n - 1,)),
            checkpointer=jck)
        ck = Checkpointer(tmp_path / f"t{every}", plan=plan, every=every)
        got, rep = run_plan_with_recovery(
            plan, ReferenceEngine(), inputs, key=key,
            faults=FaultConfig(fail_at=(n - 1,)), checkpointer=ck)
        assert_matches_jax(family, want, got, ctx=f"every={every}")
        assert (rep.restarts, rep.rounds_replayed, rep.checkpoints_written,
                rep.checkpoint_bytes, rep.failures_injected) == \
            (jrep.restarts, jrep.rounds_replayed, jrep.checkpoints_written,
             jrep.checkpoint_bytes, jrep.failures_injected)
        reports.append(rep)
    assert reports[1].rounds_replayed >= reports[0].rounds_replayed


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------

def test_checkpointer_roundtrip_mixed_tree(tmp_path):
    """Tensors keep their dtype (bfloat16 and bool too), numpy arrays stay
    numpy, Python scalars their type, NamedTuples their class."""
    ck = Checkpointer(tmp_path, tag="t")
    box = Mailbox(payload={"k": torch.arange(6.0).reshape(2, 3)},
                  valid=torch.tensor([[True, False, True]] * 2))
    tree = {"a": torch.arange(4, dtype=torch.bfloat16) / 3,
            "box": box,
            "nested": {"n": 7, "f": 2.5, "b": True, "s": "splitters"},
            "tup": (np.arange(4, dtype=np.int32), None), "l": [1, 2.0]}
    ck.save(3, tree, meta={"stage_index": 1})
    got, meta = ck.load(3, device="cpu")
    assert meta["stage_index"] == 1
    assert got["a"].dtype == torch.bfloat16 and torch.equal(got["a"],
                                                            tree["a"])
    assert isinstance(got["box"], Mailbox)
    assert torch.equal(got["box"].payload["k"], box.payload["k"])
    assert got["box"].valid.dtype == torch.bool
    assert torch.equal(got["box"].valid, box.valid)
    assert got["nested"] == tree["nested"]
    assert type(got["nested"]["n"]) is int
    assert type(got["nested"]["b"]) is bool
    assert got["tup"][1] is None
    assert isinstance(got["tup"][0], np.ndarray)
    np.testing.assert_array_equal(got["tup"][0], tree["tup"][0])
    assert got["l"] == [1, 2.0] and type(got["l"]) is list


def test_every_keep_and_disjoint_directories(tmp_path):
    ck = Checkpointer(tmp_path, tag="t", every=3)
    for r in range(1, 10):
        ck.maybe_save(r, {"r": r})
    assert ck.rounds() == [3, 6, 9] and ck.latest() == 9
    kept = Checkpointer(tmp_path / "k", tag="t", keep=2)
    for r in range(1, 6):
        kept.save(r, {"r": r})
    assert kept.rounds() == [4, 5]
    p1, p2 = _port("sort")[0], _port("prefix")[0]
    assert plan_digest(p1) != plan_digest(p2)
    c1 = Checkpointer(tmp_path / "d", plan=p1)
    c2 = Checkpointer(tmp_path / "d", plan=p2)
    c1.save(1, {"x": 1})
    assert c2.latest() is None
    with pytest.raises(ValueError):
        Checkpointer(tmp_path, tag="t", every=0)
    with pytest.raises(ValueError):
        Checkpointer(tmp_path)


def test_async_save_snapshots_on_the_caller_thread(tmp_path, monkeypatch):
    """A stalled disk write does not stall ``save``; the state written is
    the one at ``save`` time even when the caller changes it afterwards."""
    import threading
    import repro_torch.train.checkpoint as tc
    orig, gate = tc.save, threading.Event()

    def slow_save(ckpt_dir, step, tree, extra_meta=None):
        gate.wait(30.0)
        return orig(ckpt_dir, step, tree, extra_meta=extra_meta)

    monkeypatch.setattr(tc, "save", slow_save)
    ck = Checkpointer(tmp_path, tag="t", async_save=True)
    x = torch.zeros(64)
    ck.save(1, {"x": x})
    x += 5.0                         # the round loop moves on
    assert ck.saved_rounds == [1]
    gate.set()
    ck.flush()
    assert ck.latest() == 1 and ck.bytes_written >= 256
    got, _ = ck.load(1, device="cpu")
    assert torch.equal(got["x"], torch.zeros(64))


def test_async_matches_sync_and_errors_surface(tmp_path, monkeypatch):
    tree = {"a": torch.arange(12.0).reshape(3, 4), "n": 5}
    cks = Checkpointer(tmp_path / "sync", tag="t")
    cka = Checkpointer(tmp_path / "async", tag="t", async_save=True)
    cks.save(2, tree, meta={"stage_index": 1})
    cka.save(2, tree, meta={"stage_index": 1})
    cka.flush()
    assert cka.bytes_written == cks.bytes_written
    (gs, ms), (ga, ma) = cks.load(2, device="cpu"), cka.load(2, device="cpu")
    assert ms == ma and torch.equal(gs["a"], ga["a"]) and gs["n"] == ga["n"]
    ck = Checkpointer(tmp_path / "r", tag="t", every=2, async_save=True)
    for r in range(1, 7):
        ck.maybe_save(r, {"r": r})
    assert ck.rounds() == [2, 4, 6]
    import repro_torch.train.checkpoint as tc

    def broken(ckpt_dir, step, tree, extra_meta=None):
        raise OSError("disk full")

    monkeypatch.setattr(tc, "save", broken)
    bad = Checkpointer(tmp_path / "b", tag="t", async_save=True)
    bad.save(1, {"x": 1})
    with pytest.raises(OSError, match="disk full"):
        bad.flush()


@pytest.mark.parametrize("family", ["sort", "hull2d"])
def test_recovery_async_equals_sync(family, tmp_path):
    eng = get_engine("kernel", device="cpu")
    plan, inputs, key = _port(family)
    base = execute_plan(plan, eng, inputs, key=key)
    outs, sizes = {}, {}
    for mode in (False, True):
        ck = Checkpointer(tmp_path / f"a{mode}", plan=plan, every=1,
                          async_save=mode)
        outs[mode], rep = run_plan_with_recovery(
            plan, eng, inputs, key=key, faults=FaultConfig(fail_at=(1,)),
            checkpointer=ck)
        assert rep.restarts == 1
        sizes[mode] = rep.checkpoint_bytes
        assert_tree_equal(outs[mode], base, ctx=f"async={mode}")
    assert sizes[True] == sizes[False] > 0


def _rotate(r, ids, box):
    V = box.n_nodes
    dests = torch.where(box.valid, ((ids[:, None] + 1) % V).to(torch.int32),
                        -1)
    return dests, box.payload


def test_run_rounds_and_stages_checkpointer(tmp_path):
    """``run_rounds`` and ``run_stages`` offer ``{"box", "accum"}`` at
    ``round_offset + r + 1`` and compute the same with or without."""
    for eng in (ReferenceEngine(), LocalEngine(device="cpu")):
        box, _ = eng.shuffle(np.arange(16, dtype=np.int32) % 8,
                             np.arange(16.0, dtype=np.float32), 8, 4)
        ref = eng.run_rounds(_rotate, box, 5, capacity=4)
        ck = Checkpointer(tmp_path / eng.name, tag="r", every=2)
        got = eng.run_rounds(_rotate, box, 5, capacity=4, checkpointer=ck)
        assert ck.rounds() == [2, 4]
        assert_tree_equal(ref, got)
        tree, _ = ck.load(4, device="cpu")
        assert set(tree) == {"box", "accum"}
        off = Checkpointer(tmp_path / f"o{eng.name}", tag="r", every=1)
        eng.run_rounds(_rotate, box, 2, capacity=4, checkpointer=off,
                       round_offset=10)
        assert off.rounds() == [11, 12]
        st = Checkpointer(tmp_path / f"s{eng.name}", tag="s", every=1)
        stages = [(_rotate, 4), (_rotate, 4, 8)]
        assert_tree_equal(eng.run_stages(stages, box),
                          eng.run_stages(stages, box, checkpointer=st))
        assert st.rounds() == [1, 2]


def test_execute_plan_checkpointer(tmp_path):
    eng = get_engine("kernel", device="cpu")
    plan, inputs, key = _port("sort")
    ref = execute_plan(plan, eng, inputs, key=key)
    ck = Checkpointer(tmp_path, plan=plan, every=1)
    assert_tree_equal(ref, execute_plan(plan, eng, inputs, key=key,
                                        checkpointer=ck))
    assert ck.latest() == plan.total_rounds
    tree, meta = ck.load(ck.latest(), device="cpu")
    assert set(tree) == {"box", "carry", "accum"}
    assert meta["stage_index"] == len(plan.stages) - 1


def test_probabilistic_faults_and_no_checkpointer(tmp_path):
    eng = ReferenceEngine()
    plan, inputs, key = _port("sort")
    ref = execute_plan(plan, eng, inputs, key=key)
    ck = Checkpointer(tmp_path, plan=plan, every=1)
    out, rep = run_plan_with_recovery(
        plan, eng, inputs, key=key,
        faults=FaultConfig(failure_probability=0.4, seed=2),
        checkpointer=ck, max_restarts=100)
    assert rep.failures_injected >= 1
    assert_tree_equal(ref, out)
    out, rep = run_plan_with_recovery(plan, eng, inputs, key=key,
                                      faults=FaultConfig(fail_at=(1,)))
    assert rep.restarts == 1 and rep.rounds_replayed > 0
    assert_tree_equal(ref, out)


def test_max_restarts_exceeded_raises(tmp_path):
    plan, inputs, key = _port("sort")
    ck = Checkpointer(tmp_path, plan=plan, every=1)
    with pytest.raises(ShardFailure):
        run_plan_with_recovery(
            plan, ReferenceEngine(), inputs, key=key,
            faults=FaultConfig(failure_probability=1.0),
            checkpointer=ck, max_restarts=3)


@pytest.mark.parametrize("family", ["sort", "hull2d", "prefix"])
def test_resume_on_the_other_engine(family, tmp_path):
    """Killed on the kernel engine, resumed on the dense one (and the
    reference one): equal to the fault-free run and to the JAX package's."""
    _, want = _jax_run(family)
    kernel = get_engine("kernel", device="cpu")
    plan, inputs, key = _port(family)
    ref = execute_plan(plan, kernel, inputs, key=key)
    n = _count_shuffles(plan, kernel, inputs, key)
    ck = Checkpointer(tmp_path, plan=plan, every=1)
    with pytest.raises(ShardFailure):
        run_plan_with_recovery(plan, kernel, inputs, key=key,
                               faults=FaultConfig(fail_at=(n - 1,)),
                               checkpointer=ck, max_restarts=0)
    last = ck.latest()
    assert last is not None
    for other in (LocalEngine(device="cpu"), ReferenceEngine()):
        out, rep = resume_plan(plan, other, inputs, key=key, checkpointer=ck,
                               at_round=last)
        assert rep.resumed_at_round == last
        assert_tree_equal(ref, out, ctx=other.name)
        assert_matches_jax(family, want, out, ctx=other.name)
    with pytest.raises(ValueError, match="no checkpoint"):
        resume_plan(plan, kernel, inputs,
                    checkpointer=Checkpointer(tmp_path / "none", plan=plan))


class _Granular(ReferenceEngine):
    """A reference engine whose layout granularity is 4 nodes."""

    def aligned_nodes(self, n_nodes):
        return -(-int(n_nodes) // 4) * 4


def test_realign_mailbox_matches_jax():
    jbox, _ = J.ReferenceEngine().shuffle(np.arange(6, dtype=np.int32) % 3,
                                          np.arange(6.0, dtype=np.float32),
                                          3, 4)

    class JGranular(J.ReferenceEngine):
        def aligned_nodes(self, n_nodes):
            return -(-int(n_nodes) // 4) * 4

    want = JR.realign_mailbox(jbox, JGranular())
    box, _ = ReferenceEngine().shuffle(np.arange(6, dtype=np.int32) % 3,
                                       np.arange(6.0, dtype=np.float32), 3, 4)
    got = realign_mailbox(box, _Granular())
    assert got.n_nodes == 4
    np.testing.assert_array_equal(got.payload.numpy(),
                                  np.asarray(want.payload))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    same = realign_mailbox(box, ReferenceEngine())
    assert torch.equal(same.payload, box.payload)


def test_elastic_engine_is_not_ported_yet():
    """``elastic_engine`` is ported (tests/test_torch_distributed.py runs
    it on gloo ranks); without a process group it refuses to build one,
    and it refuses zero shards."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        elastic_engine(2, device="cpu")
    with pytest.raises(ValueError, match="n_shards"):
        elastic_engine(0, device="cpu")


def test_recovery_report_defaults():
    assert RecoveryReport() == RecoveryReport(
        restarts=0, rounds_replayed=0, checkpoints_written=0,
        checkpoint_bytes=0, failures_injected=0, stragglers_injected=0,
        simulated_delay_s=0.0, resumed_at_round=None)


def test_async_saver_copies_cpu_tensors_before_returning(tmp_path):
    """The trainer's ``AsyncSaver`` on CPU tensors: an in-place update right
    after ``save_async`` (an optimizer step) does not reach the file."""
    from repro_torch.train.checkpoint import AsyncSaver, restore
    w = torch.arange(8.0)
    saver = AsyncSaver()
    saver.save_async(str(tmp_path), 1, {"w": w})
    w.add_(100.0)
    saver.wait()
    got, meta = restore(str(tmp_path), 1, {"w": torch.zeros(8)})
    assert meta["step"] == 1
    assert torch.equal(got["w"], torch.arange(8.0))

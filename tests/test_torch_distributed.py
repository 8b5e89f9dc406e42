"""The port's sharded round machine (``ShardedEngine``,
``repro_torch.core.distributed``, the overlapped schedule and
``elastic_engine``) against the JAX package.

Multi-rank cases run ``python -m repro_torch.dist_check`` once per group
size, in a subprocess under a timeout: it spawns gloo CPU ranks over a
``file://`` store and each rank writes what it computed to an ``.npz``.
The tests hold every rank's results equal to each other and, bit for bit,
to the JAX package's ``LocalEngine`` on the same numpy inputs and the same
draws (the JAX package's own, handed to the ranks as sample indices), with
the JAX engine's ``aligned_nodes`` rounded up to the group size so both run
the same schedule.  The LP's basis solves are held within the tolerances of
tests/test_torch_geometry.py, the float collectives within 1e-6 / 1e-5 as
tests/test_distributed.py holds them.  Group size 1 runs in-process and is
also held against the JAX ``ShardedEngine`` on direct calls.
"""
import functools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
import repro.core as J
from repro.core import distributed as JD
from repro_torch import dist_check as DC
from repro_torch._tree import tree_leaves
from repro_torch.core import CostAccum, ShardedEngine, get_engine
from repro_torch.core import distributed as D
from repro_torch.core.kshuffle import RouteLog
from repro_torch.testing import assert_same_accum, assert_same_box

ROOT = pathlib.Path(__file__).resolve().parents[1]
LP_OBJ_RTOL = 1e-5
LP_X_ATOL = 1e-4
#: the plan families that declare early_dests stages (their overlapped
#: runs issue windows)
EARLY = ("sort", "sort2", "multisearch", "prefix", "prefix-exclusive",
         "hull2d")
WORLD_CASES = {2: "shuffle,rounds,plans,tracer,errors",
               4: "shuffle,rounds,plans,collectives,elastic,errors"}
FAMILIES = list(DC.family_inputs())


@pytest.fixture(autouse=True)
def jax_trace_state_clean(monkeypatch):
    """The JAX package's tracer calls ``jax.core.trace_state_clean``, which
    some jax releases keep only as ``jax._src.core.trace_state_clean``."""
    if not hasattr(jax.core, "trace_state_clean"):
        from jax._src import core as jax_src_core
        monkeypatch.setattr(jax.core, "trace_state_clean",
                            jax_src_core.trace_state_clean, raising=False)


def _jax_draws() -> dict:
    """The JAX package's draws for each family's default key, as the port's
    sample indices."""
    key = jax.random.PRNGKey(DC.SEED)
    out = {}
    for name, (kind, n) in DC.FAMILY_DRAWS.items():
        if kind == "perm":
            out[name] = np.asarray(jax.random.permutation(key, n))
        else:
            universe = min(max(n, 2) ** 3, 2**31 - 1)
            out[name] = np.asarray(jax.random.randint(key, (n,), 0, universe,
                                                      dtype=jnp.int32))
    out["elastic"] = np.asarray(jax.random.permutation(key, 64))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """world -> the ranks' results, each world's ranks run once (every
    world started at once, each joined at its first use)."""
    root = tmp_path_factory.mktemp("ranks")
    keys = root / "keys.npz"
    np.savez(keys, **_jax_draws())
    procs = {world: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.dist_check", "--world",
         str(world), "--out", str(root / f"world{world}"), "--keys",
         str(keys), "--cases", cases, "--timeout", "150"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        for world, cases in WORLD_CASES.items()}

    @functools.lru_cache(maxsize=None)
    def run(world):
        stdout, stderr = procs[world].communicate(timeout=180)
        assert procs[world].returncode == 0, stdout + stderr[-6000:]
        return DC.load_ranks(root / f"world{world}", world)
    try:
        yield run
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture
def world1(tmp_path):
    """A gloo group of one rank in this process, destroyed afterwards."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


class _AlignedLocal(J.LocalEngine):
    """The JAX LocalEngine at a layout granularity of ``k`` nodes: the
    schedule a ShardedEngine over ``k`` ranks runs."""

    def __init__(self, k):
        super().__init__()
        self.k = k

    def aligned_nodes(self, n_nodes):
        return DC.aligned(n_nodes, self.k)


def _leaves(tree):
    return [np.asarray(l) for l in jax.tree_util.tree_leaves(tree)]


def _entries(res, case, variant):
    out, j = [], 0
    while f"{case}/{variant}/{j}" in res:
        out.append(res[f"{case}/{variant}/{j}"])
        j += 1
    return out


def _assert_leaves(want, got, ctx, fuzzy=()):
    assert len(want) == len(got), f"{ctx}: {len(want)} vs {len(got)} leaves"
    for j, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype, f"{ctx} leaf {j}: {w.dtype} vs {g.dtype}"
        if j in fuzzy:
            continue
        np.testing.assert_array_equal(g, w, err_msg=f"{ctx} leaf {j}")


def _same_on_every_rank(rs, case, variants):
    for v in variants:
        ref = _entries(rs[0], case, v)
        assert ref, f"{case}/{v}: no entries"
        for r, res in enumerate(rs[1:], 1):
            _assert_leaves(ref, _entries(res, case, v), f"{case}/{v} rank {r}")


# ---------------------------------------------------------------------------
# Direct shuffles and round programs
# ---------------------------------------------------------------------------

def _jax_shuffle(dests, leaves, V, cap, engine=None):
    payload = leaves[0] if len(leaves) == 1 else tuple(leaves)
    return (engine or J.LocalEngine()).shuffle(dests, payload, V, cap)


@pytest.mark.parametrize("i", range(3))
def test_shuffle_world1_matches_jax(world1, i):
    """At one rank: the dense and the kernel scatter against the JAX
    LocalEngine and the JAX ShardedEngine (mailbox, every stat and its
    int32 dtype)."""
    dests, leaves, V, cap = DC.shuffle_inputs(1)[i]
    payload = leaves[0] if len(leaves) == 1 else tuple(leaves)
    wants = [_jax_shuffle(dests, leaves, V, cap),
             _jax_shuffle(dests, leaves, V, cap, J.ShardedEngine())]
    for impl in ("dense", "kernel"):
        eng = ShardedEngine(shuffle_impl=impl, device="cpu")
        assert (eng.n_shards, eng.shard) == (1, 0)
        box, st = eng.shuffle(dests, payload, V, cap)
        for wbox, wst in wants:
            assert_same_box(wbox, box, ctx=impl)
            _assert_leaves(_leaves(wst), [s.numpy() for s in st], impl)
    assert eng.route_log.snapshot() == (1, 0)


@pytest.mark.parametrize("world", [2, 4])
def test_shuffle_matches_jax(ranks, world):
    rs = ranks(world)
    for i, (dests, leaves, V, cap) in enumerate(DC.shuffle_inputs(world)):
        wbox, wst = _jax_shuffle(dests, leaves, V, cap)
        want = _leaves((wbox, wst))
        for variant in ("dense", "kernel", "local"):
            _assert_leaves(want, _entries(rs[0], f"shuffle-{i}", variant),
                           f"shuffle-{i} {variant} world {world}")
        _same_on_every_rank(rs, f"shuffle-{i}", ("dense", "kernel"))
    assert rs[0]["shuffle/kernel/#routes"].tolist() == [3, 0]


def _jax_rounds(seed, k):
    V, cap, entry, payload, tables = DC.round_program(seed, k)
    t = jnp.asarray(tables)
    fn = lambda r, ids, box: (jnp.where(box.valid, t[r], -1), box.payload)  # noqa: E731
    eng = J.LocalEngine()
    box, st = eng.shuffle(entry, payload, V, cap)
    acc0 = J.CostAccum.zero().add_round_stats(st)
    rounds = eng.run_rounds(fn, box, len(tables), accum=acc0)
    stages = eng.run_stages([(fn, cap, None, e) for e in DC.STAGE_FLAGS],
                            box, accum=acc0)
    return rounds, stages


@pytest.mark.parametrize("seed", range(3))
def test_rounds_world1_matches_jax(world1, seed):
    """At one rank: run_rounds sequential and overlapped, early_dests on
    and off, against the JAX LocalEngine and ShardedEngine; the overlapped
    scheduler counts its rounds as the JAX one does."""
    V, cap, entry, payload, tables = DC.round_program(seed, 1)
    (wbox, wacc), (sbox, sacc) = _jax_rounds(seed, 1)
    t = jnp.asarray(tables)
    jfn = lambda r, ids, box: (jnp.where(box.valid, t[r], -1), box.payload)  # noqa: E731
    jsh = J.ShardedEngine()
    jbox, jst = jsh.shuffle(entry, payload, V, cap)
    jbox, jacc = jsh.run_rounds(jfn, jbox, len(tables),
                                accum=J.CostAccum.zero().add_round_stats(jst),
                                early_dests=True)
    assert_same_box(wbox, jbox)
    fn = DC._port_fn(tables)
    for overlap in (False, True):
        for early in (False, True):
            eng = ShardedEngine(device="cpu", overlap=overlap)
            box, st = eng.shuffle(entry, payload, V, cap)
            acc0 = CostAccum.zero().add_round_stats(st)
            box, acc = eng.run_rounds(fn, box, len(tables), accum=acc0,
                                      early_dests=early)
            ctx = f"overlap={overlap} early={early}"
            assert_same_box(wbox, box, ctx=ctx)
            assert_same_accum(wacc, acc, ctx=ctx)
            assert_same_accum(jacc, acc, ctx=ctx)
            engaged = overlap and early
            assert eng.route_log.overlapped == (len(tables) if engaged
                                                else 0)
            if engaged:
                assert eng.route_log.overlapped == \
                    jsh.route_log.overlapped
            box, st = eng.shuffle(entry, payload, V, cap)
            box, acc = eng.run_stages(
                [(fn, cap, None, e) for e in DC.STAGE_FLAGS], box,
                accum=CostAccum.zero().add_round_stats(st))
            assert_same_box(sbox, box, ctx=ctx + " stages")
            assert_same_accum(sacc, acc, ctx=ctx + " stages")


@pytest.mark.parametrize("world,seed", [(w, s) for w in (2, 4)
                                        for s in range(3)])
def test_rounds_match_jax(ranks, world, seed):
    rs = ranks(world)
    (wbox, wacc), (sbox, sacc) = _jax_rounds(seed, world)
    want, swant = _leaves((wbox, wacc)), _leaves((sbox, sacc))
    variants = ("seq", "seq-early", "overlap", "overlap-late")
    for v in variants + ("local",):
        _assert_leaves(want, _entries(rs[0], f"rounds-{seed}", v),
                       f"rounds-{seed} {v} world {world}")
    for v in ("stages", "stages-seq", "local"):
        _assert_leaves(swant, _entries(rs[0], f"stages-{seed}", v),
                       f"stages-{seed} {v} world {world}")
    _same_on_every_rank(rs, f"rounds-{seed}", variants)
    _same_on_every_rank(rs, f"stages-{seed}", ("stages", "stages-seq"))
    counts = {v: int(rs[0][f"rounds-{seed}/{v}/#overlapped"])
              for v in variants}
    assert counts == {"seq": 0, "seq-early": 0, "overlap": 4,
                      "overlap-late": 0}
    assert int(rs[0][f"stages-{seed}/stages/#overlapped"]) == \
        sum(DC.STAGE_FLAGS)
    assert int(rs[0][f"stages-{seed}/stages-seq/#overlapped"]) == 0


# ---------------------------------------------------------------------------
# Every plan family
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_family(name, k):
    key = (jax.random.PRNGKey(DC.SEED) if name in DC.FAMILY_DRAWS
           else None)
    eng = _AlignedLocal(k)
    out = DC.run_family(name, J, jnp, eng, eng.aligned_nodes,
                        DC.family_inputs()[name], key, jnp.asarray)
    return _leaves(out)


@pytest.mark.parametrize("world,family", [(w, f) for w in (2, 4)
                                          for f in FAMILIES])
def test_plan_family_matches_jax(ranks, world, family):
    """The family on the overlapped and the sequential sharded engine (and
    on the kernel scatter for the sort and the 2-D hull) against the JAX
    LocalEngine at the group's layout granularity: every output and
    CostAccum leaf, on every rank.  Overlapped equals sequential; the
    families with early stages issue windows, the others none."""
    rs = ranks(world)
    want = _jax_family(family, world)
    variants = ["overlap", "seq"] + (["kernel"] if family in
                                     DC.KERNEL_FAMILIES else [])
    fuzzy = {0, 1} if family == "lp" else set()      # x, objective
    for v in variants + ["local"]:
        got = _entries(rs[0], family, v)
        _assert_leaves(want, got, f"{family} {v} world {world}", fuzzy)
        if family == "lp":
            np.testing.assert_allclose(got[0], want[0], atol=LP_X_ATOL)
            w = float(want[1])
            assert abs(float(got[1]) - w) <= LP_OBJ_RTOL * max(1.0, abs(w))
    _same_on_every_rank(rs, family, variants)
    for v in variants:
        _assert_leaves(_entries(rs[0], family, "local"),
                       _entries(rs[0], family, v), f"{family} {v} vs local")
    overlapped = int(rs[0][f"{family}/overlap/#overlapped"])
    assert (overlapped > 0) == (family in EARLY)
    assert int(rs[0][f"{family}/seq/#overlapped"]) == 0
    if "kernel" in variants:
        kernel, dense = rs[0][f"{family}/kernel/#routes"].tolist()
        assert kernel > 0 and dense == 0


@pytest.mark.parametrize("family", ["sort", "hull2d", "multisearch",
                                    "prefix"])
def test_early_dests_declared_as_jax(family):
    """The stages that declare early_dests, stage by stage, are the JAX
    package's."""
    import repro_torch.core as T

    def flags(m):
        return {"sort": lambda: m.sort_plan(4096, 16, levels=3),
                "hull2d": lambda: m.hull2d_plan(4096, 16),
                "multisearch": lambda: m.multisearch_plan(256, 64, 8),
                "prefix": lambda: m.prefix_plan(256, 8, physical=True),
                }[family]().stages

    want = [(s.name, s.early_dests) for s in flags(J)]
    got = [(s.name, s.early_dests) for s in flags(T)]
    assert got == want and any(e for _, e in got)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def test_shuffle_alltoall_delivery_and_fifo(ranks):
    """Every item lands on the rank its dest names, in its sender's order,
    in the row of its sender; past the per-pair capacity it is dropped and
    counted over the group."""
    rs = ranks(4)
    x = DC.collective_inputs(4)
    dests, vals = x["a2a_dests"], x["a2a_vals"]
    for tag, cap in (("c-alltoall", 16), ("c-alltoall-cap3", 3)):
        want_dropped = sum(max(0, int((dests[i] == r).sum()) - cap)
                           for i in range(4) for r in range(4))
        for r, res in enumerate(rs):
            payload, valid, dropped = _entries(res, tag, "per-rank")
            assert payload.shape == (4, cap) and valid.dtype == np.bool_
            assert int(dropped) == want_dropped
            for i in range(4):
                sent = vals[i][dests[i] == r][:cap]
                np.testing.assert_array_equal(valid[i],
                                              np.arange(cap) < len(sent))
                np.testing.assert_array_equal(payload[i][:len(sent)], sent)


def test_funnel_allreduce_matches_the_sum(ranks):
    """Inner groups of two ranks and outer groups across them: the sum
    over all four ranks, along dim 0, dim 1, and a dim the inner group does
    not divide."""
    rs = ranks(4)
    x = DC.collective_inputs(4)
    for tag, src in (("c-funnel", "funnel"), ("c-funnel_odd", "funnel_odd"),
                     ("c-funnel-dim1", "funnel")):
        for res in rs:
            (got,) = _entries(res, tag, "sharded")
            np.testing.assert_allclose(got, x[src].sum(0), rtol=1e-6,
                                       atol=1e-6)


def test_softmax_merge_axis_matches_full_softmax(ranks):
    rs = ranks(4)
    x = DC.collective_inputs(4)
    s = x["kv_k"] @ x["q"]
    w = np.exp(s - s.max())
    want = (w / w.sum()) @ x["kv_v"]
    for res in rs:
        (got,) = _entries(res, "c-softmax", "sharded")
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_sharded_sample_sort_matches_np_sort(ranks):
    rs = ranks(4)
    x = DC.collective_inputs(4)["sort_x"]
    parts = []
    for res in rs:
        values, valid, dropped = _entries(res, "c-sample-sort", "per-rank")
        assert int(dropped) == 0
        assert np.all(np.diff(values[valid]) >= 0)
        parts.append(values[valid])
    np.testing.assert_array_equal(np.concatenate(parts), np.sort(x))


def test_segment_scatter_add_matches_jax():
    rng = np.random.default_rng(9)
    dests = rng.integers(-1, 9, (6, 5)).astype(np.int32)   # 8 is past n_cells
    for values in (rng.integers(-9, 9, (6, 5, 3)).astype(np.int32),
                   rng.normal(size=(6, 5)).astype(np.float32)):
        want = np.asarray(JD.segment_scatter_add(jnp.asarray(dests),
                                                 jnp.asarray(values), 8))
        got = D.segment_scatter_add(torch.from_numpy(dests),
                                    torch.from_numpy(values), 8).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_softmax_merge_pair_matches_jax():
    rng = np.random.default_rng(10)
    parts = [[rng.normal(size=(4,)).astype(np.float32),
              rng.uniform(0.5, 2, (4,)).astype(np.float32),
              rng.normal(size=(4, 8)).astype(np.float32)] for _ in range(2)]
    want = JD.softmax_merge_pair(*(JD.AttnPartial(*map(jnp.asarray, p))
                                   for p in parts))
    got = D.softmax_merge_pair(*(D.AttnPartial(*map(torch.from_numpy, p))
                                 for p in parts))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_collectives_world1(world1):
    """At one rank every collective is the local operation."""
    x = torch.arange(12.0).reshape(3, 4)
    assert torch.equal(D.funnel_allreduce(x, None), x)
    out = D.shuffle_alltoall(torch.tensor([0, -1, 0, 0], dtype=torch.int32),
                             torch.arange(4.0), None, capacity=2)
    assert out.payload.tolist() == [[0.0, 2.0]]
    assert out.valid.tolist() == [[True, True]] and int(out.dropped) == 1
    s = D.sharded_sample_sort(torch.tensor([3.0, 1.0, 2.0]), None)
    assert s.values[s.valid].tolist() == [1.0, 2.0, 3.0]
    p = D.AttnPartial(m=torch.tensor(1.0), l=torch.tensor(2.0),
                      o=torch.tensor([4.0, 6.0]))
    assert D.softmax_merge_axis(p, None).tolist() == [2.0, 3.0]


# ---------------------------------------------------------------------------
# Elastic resume, the tracer, errors
# ---------------------------------------------------------------------------

def test_elastic_resume_4_to_2(ranks):
    """A sort checkpointed every stage on four ranks, killed at shuffle
    attempt 1, resumed on the first two: outputs and CostAccum equal the
    fault-free run and the JAX LocalEngine's, bit for bit."""
    rs = ranks(4)
    eng = _AlignedLocal(4)
    plan = J.sort_plan(64, 8, align=eng.aligned_nodes)
    x = np.random.default_rng(3).permutation(64).astype(np.float32)
    want = _leaves(eng.compile(plan)(x, key=jax.random.PRNGKey(DC.SEED)))
    for r, res in enumerate(rs):
        assert bool(res["elastic/fault-free/#fired"])
        assert int(res["elastic/fault-free/#n_shards"]) == 4
        _assert_leaves(want, _entries(res, "elastic", "fault-free"),
                       f"fault-free rank {r}")
        if r < 2:
            assert int(res["elastic/resumed/#n_shards"]) == 2
            assert int(res["elastic/resumed/#at"]) == \
                int(res["elastic/fault-free/#latest"]) > 0
            _assert_leaves(want, _entries(res, "elastic", "resumed"),
                           f"resumed rank {r}")
        else:
            assert not _entries(res, "elastic", "resumed")
        assert bool(res["elastic/refusals/#over"])
        assert bool(res["elastic/refusals/#zero"])
    _assert_leaves(want, _entries(rs[0], "elastic", "local"), "local")


def test_elastic_engine_world1(world1):
    from repro_torch.core.recovery import elastic_engine
    eng = elastic_engine(1, device="cpu", shuffle_impl="kernel")
    assert isinstance(eng, ShardedEngine) and eng.n_shards == 1
    assert eng.shuffle_impl == "kernel"
    with pytest.raises(ValueError, match="healthy"):
        elastic_engine(2, device="cpu")
    with pytest.raises(ValueError):
        elastic_engine(0, device="cpu")


def test_tracer_events_world2(ranks):
    """Traced, untraced and sequential runs give the same box and
    accumulator; the overlapped run records pipeline.hop once a round and
    pipeline.overlap once a window, the sequential run no pipeline.*
    event."""
    rs = ranks(2)
    ref = _entries(rs[0], "tracer", "seq")
    for v in ("traced", "untraced"):
        _assert_leaves(ref, _entries(rs[0], "tracer", v), v)
    _same_on_every_rank(rs, "tracer", ("traced", "untraced", "seq"))
    V, cap, R, entry, payload = DC.tracer_program(2)
    node = jnp.arange(V, dtype=jnp.int32)[:, None]
    jeng = J.LocalEngine()
    box, st = jeng.shuffle(entry, payload, V, cap)
    box, acc = jeng.run_rounds(
        lambda r, ids, b: (jnp.where(b.valid, (node + 1 + r) % V, -1),
                           b.payload),
        box, R, accum=J.CostAccum.zero().add_round_stats(st))
    _assert_leaves(_leaves((box, acc)), ref, "vs JAX")
    for res in rs:
        assert int(res["tracer/traced/#hops"]) == R
        assert int(res["tracer/traced/#overlaps"]) == 1
        assert int(res["tracer/seq/#pipeline"]) == 0


def test_traced_world1_summary(world1):
    """The port's summary folds the overlapped schedule's events: one
    window of R rounds, R hops, and the plan's stages measured as
    declared."""
    from repro_torch.core import sort_plan
    from repro_torch.obs import Tracer, summarize
    tr = Tracer()
    eng = ShardedEngine(device="cpu", tracer=tr)
    x = np.random.default_rng(0).normal(size=96).astype(np.float32)
    plan = sort_plan(96, 8, levels=2, align=eng.aligned_nodes)
    res = eng.compile(plan)(x, key=3)
    plain = ShardedEngine(device="cpu").compile(plan)(x, key=3)
    for a, b in zip(tree_leaves(res), tree_leaves(plain)):
        assert torch.equal(a, b)
    report = summarize(tr)
    assert report["schedule_ok"]
    assert report["pipeline"]["windows"] == 2
    assert report["pipeline"]["overlapped_rounds"] == 2
    assert report["pipeline"]["hops"] == 2


@pytest.mark.parametrize("world", [2, 4])
def test_node_counts_must_divide(ranks, world):
    res = ranks(world)[0]
    assert bool(res["errors/sharded/#nodes"])
    assert bool(res["errors/sharded/#lead"])


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_holds_the_same_result(ranks, world):
    """dist_check's own check: every rank's entries equal rank 0's, and
    every sharded variant equals the port's LocalEngine."""
    assert DC.check_results(ranks(world)) > 100


def test_engine_refuses_without_a_group_or_with_the_wrong_backend(
        world1, monkeypatch):
    assert get_engine("sharded", device="cpu").name == "sharded"
    with pytest.raises(ValueError, match="shuffle_impl"):
        ShardedEngine(shuffle_impl="pallas", device="cpu")
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(ValueError, match="needs a gloo process group"):
        ShardedEngine(device="cpu")
    monkeypatch.setattr(dist, "get_backend",
                        lambda group=None: "cpu:gloo,cuda:nccl")
    assert ShardedEngine(device="cpu").n_shards == 1


def test_engine_refuses_without_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        ShardedEngine(device="cpu")


def test_route_log_overlapped_is_reset_and_left_out_of_snapshot():
    log = RouteLog()
    log.kernel, log.dense, log.overlapped = 2, 1, 5
    assert log.snapshot() == (2, 1)
    log.reset()
    assert (log.kernel, log.dense, log.overlapped) == (0, 0, 0)

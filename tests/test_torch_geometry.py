"""The paper's geometry in the port — the 2-D hull's monotone-chain reducer
and plan, the 3-D hull through the CRCW funnels, fixed-dimensional LP —
against the JAX package on the same numpy inputs.

Tolerances: hulls, hull counts, 3-D masks, LP feasible sets and every
``CostAccum`` field are equal, bit for bit.  The chain runs the same float32
operations in the same order in both packages, and the integer-grid points
in [-1024, 1024) make every orientation test exact, so collinear ties are
decided the same way.  LP objectives agree within 1e-5 relative and the
optimal vertex within 1e-4: the two packages solve their d x d systems with
different LU codes (LAPACK through PyTorch, XLA's own), which round
differently in the last float32 digits.

The 2-D plans take the JAX package's splitter draw as sample indices.
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.core as J
from repro.core.geometry import chain as jax_chain
from repro.core.geometry import hull3d as jax_hull3d
from repro.core.geometry import lp as jax_lp
from repro.core.geometry.util import combinations_array as jax_combinations
from repro_torch.core import (LocalEngine, MRCost, ReferenceEngine,
                              convex_hull_2d, convex_hull_2d_mr,
                              convex_hull_3d, convex_hull_3d_mr,
                              convex_hull_3d_oracle, convex_hull_oracle,
                              get_engine, hull2d_plan, hull3d_plan,
                              hull3d_round_bound, hull_round_bound,
                              linear_program_mr, linear_program_nd,
                              linear_program_oracle, lp_plan, lp_round_bound)
from repro_torch.core.geometry import chain, hull3d, lp
from repro_torch.core.geometry.util import combinations_array
from repro_torch import testing
from repro_torch.kernels.chain import monotone_chain_plain
from repro_torch.testing import assert_same_accum

LP_OBJ_RTOL = 1e-5      # objective, relative
LP_X_ATOL = 1e-4        # optimal vertex, absolute

DEGENERATE_2D = {       # tests/test_geometry.py's cases
    "collinear": [[0, 0], [1, 1], [2, 2], [3, 3]],
    "collinear-with-dups": [[0, 0], [1, 1], [2, 2], [3, 3], [0, 0], [3, 3]],
    "all-identical": [[2, 2]] * 5,
    "two-duplicates": [[1, 2], [1, 2]],
    "single-point": [[3, 4]],
    "two-distinct": [[1, 1], [0, 0]],
    "square-with-interior": [[0, 0], [3, 0], [3, 3], [0, 3], [1, 1], [2, 2]],
}


def _port_engines():
    return [ReferenceEngine(), LocalEngine(device="cpu"),
            get_engine("kernel", device="cpu")]


def _jax_engines():
    return [J.ReferenceEngine(), J.LocalEngine()]


def _with_dead_slots(runs, seed, cap):
    """(V, cap, 2) float32 mailbox holding each run's points at random
    slots, the other slots dead and holding garbage."""
    rng = np.random.default_rng(seed)
    V = len(runs)
    pts = rng.normal(size=(V, cap, 2)).astype(np.float32) * 1e3
    valid = np.zeros((V, cap), bool)
    for v, run in enumerate(runs):
        slots = np.sort(rng.choice(cap, len(run), replace=False))
        pts[v, slots] = np.asarray(run, np.float32).reshape(-1, 2)
        valid[v, slots] = True
    return pts, valid


def _mailboxes():
    rng = np.random.default_rng(3)
    grid = [rng.integers(-1024, 1024, (k, 2)) for k in (3, 17, 40, 64)]
    # a narrow grid: many duplicates and collinear triples
    grid += [rng.integers(-3, 3, (k, 2)) for k in (9, 30, 60)]
    gauss = [rng.normal(size=(k, 2)) for k in (5, 33, 64)]
    return {
        "degenerate": _with_dead_slots(list(DEGENERATE_2D.values()), 0, 12),
        "tiny": _with_dead_slots([[], [[1, 2]], [[1, 2], [-3, 0.5]],
                                  [[0, 0], [0, 0]], []], 1, 5),
        "grid": _with_dead_slots(grid, 2, 80),
        "gauss": _with_dead_slots(gauss, 4, 96),
    }


# ----------------------------------------------------------- the reducer
@pytest.mark.parametrize("case", ["degenerate", "tiny", "grid", "gauss"])
def test_sort_dedup_runs_matches_jax(case):
    pts, valid = _mailboxes()[case]
    want_p, want_ok = jax_chain.sort_dedup_runs(jnp.asarray(pts),
                                                jnp.asarray(valid))
    got_p, got_ok = chain.sort_dedup_runs(torch.from_numpy(pts),
                                          torch.from_numpy(valid))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))


@pytest.mark.parametrize("case", ["degenerate", "tiny", "grid", "gauss"])
def test_hull_of_runs_matches_jax(case):
    pts, valid = _mailboxes()[case]
    want_h, want_c = jax_chain.hull_of_runs(jnp.asarray(pts),
                                            jnp.asarray(valid))
    got_h, got_c = chain.hull_of_runs(torch.from_numpy(pts),
                                      torch.from_numpy(valid))
    assert got_h.dtype == torch.float32 and got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def _chain_edge_mailbox(case):
    """A mailbox (with dead slots) of runs from one input family that the
    card's chain kernel treats apart: chains deeper than its shared-memory
    window that then pop to the bottom, near-collinear float32 points, x
    ties, lengths across its stage sizes, runs of 0, 1 and 2 points, and
    subnormal coordinates."""
    rng = np.random.default_rng(sum(map(ord, case)))
    runs = {
        "deep-pop-lower": lambda: [testing.deep_pop_run(600, "lower"),
                                   testing.deep_pop_run(300, "lower")],
        "deep-pop-upper": lambda: [testing.deep_pop_run(600, "upper"),
                                   testing.parabola_run(700, -1.0)],
        "near-collinear": lambda: [testing.near_collinear_run(600, rng)
                                   for _ in range(2)],
        "x-ties": lambda: [testing.x_ties_run(500, rng) for _ in range(2)],
        "lengths-1023-1025": lambda: [testing.gauss_run(k, rng)
                                      for k in (1023, 1024, 1025)],
        "lengths-2047-2049": lambda: [testing.gauss_run(k, rng)
                                      for k in (2047, 2048, 2049)],
        "counts-0-1-2": lambda: [[], [[1.5, -2.0]], [[0.5, 3.0], [-1.0, 2.0]],
                                 testing.gauss_run(5, rng), []],
        # subnormal coordinates: XLA flushes them to zero in the tests and
        # keeps them as they are in the hull
        "subnormal": lambda: [[[0, 0], [1e-40, 5], [1, 1e-41], [2, 3]],
                              testing.lex_unique(testing.gauss_run(300, rng)
                                                 * np.float32(1e-38))],
    }[case]()
    cap = max(len(r) for r in runs) + 9
    return _with_dead_slots(runs, len(case), cap)


@pytest.mark.parametrize("case", ["deep-pop-lower", "deep-pop-upper",
                                  "near-collinear", "x-ties",
                                  "lengths-1023-1025", "lengths-2047-2049",
                                  "counts-0-1-2", "subnormal"])
def test_hull_of_runs_matches_jax_on_chain_edge_families(case):
    """The card kernel's yardstick, monotone_chain_plain through
    hull_of_runs, against the JAX scan on the families the card tests
    use: hulls and counts bit for bit."""
    pts, valid = _chain_edge_mailbox(case)
    want_h, want_c = jax_chain.hull_of_runs(jnp.asarray(pts),
                                            jnp.asarray(valid))
    got_h, got_c = chain.hull_of_runs(torch.from_numpy(pts),
                                      torch.from_numpy(valid))
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    if case.startswith("deep-pop"):
        assert got_c.tolist()[0] == 3


@pytest.mark.parametrize("n", [4, 5, 4099, 9000])
def test_extreme_run_is_its_own_hull_in_both_packages(n):
    """Every point of ``testing.extreme_run`` is a vertex of its hull, in
    order, under the JAX chain and the port's."""
    run = testing.extreme_run(n)
    pts, valid = run[None], np.ones((1, n), bool)
    want_h, want_c = jax_chain.hull_of_runs(jnp.asarray(pts),
                                            jnp.asarray(valid))
    got_h, got_c = chain.hull_of_runs(torch.from_numpy(pts),
                                      torch.from_numpy(valid))
    assert int(want_c[0]) == int(got_c[0]) == n
    np.testing.assert_array_equal(np.asarray(want_h)[0], run)
    np.testing.assert_array_equal(got_h[0].numpy(), run)


def test_extreme_run_keeps_every_turn_at_its_full_size():
    """At 2^20 points (the card's worst-case run) every test of three
    consecutive points turns left under the chain's float32 turn test, and
    every test of the upper chain, which walks back from the last point,
    pops: the lower chain keeps every point and the upper chain none."""
    from repro_torch.kernels.chain import _turn
    r = torch.from_numpy(testing.extreme_run(1 << 20))
    a, b, p = r[:-2], r[1:-1], r[2:]
    assert bool((_turn(a[:, 0], a[:, 1], b[:, 0], b[:, 1], p[:, 0], p[:, 1])
                 > 0).all())
    last = r[-1].expand(len(b), 2)
    assert bool((_turn(last[:, 0], last[:, 1], b[:, 0], b[:, 1], a[:, 0],
                       a[:, 1]) <= 0).all())


@pytest.mark.parametrize("name", sorted(DEGENERATE_2D))
def test_hull_of_one_degenerate_run_is_the_oracle(name):
    pts, valid = _with_dead_slots([DEGENERATE_2D[name]], 5, 9)
    hull, h = chain.hull_of_runs(torch.from_numpy(pts),
                                 torch.from_numpy(valid))
    want = convex_hull_oracle(np.asarray(DEGENERATE_2D[name], np.float64))
    np.testing.assert_array_equal(hull[0, :int(h[0])].numpy(), want)
    assert not hull[0, int(h[0]):].any()


def test_monotone_chain_plain_keeps_every_parabola_point():
    """Integer points on y = x^2: every turn is exact and strictly convex,
    so the lower chain keeps all of them and the hull is the whole run."""
    x = np.arange(-300, 300, dtype=np.float32)
    run = torch.from_numpy(np.stack([x, x * x], 1))[None]
    hull, h = monotone_chain_plain(run, torch.tensor([600], dtype=torch.int32))
    assert h.tolist() == [600]
    np.testing.assert_array_equal(hull[0].numpy(), run[0].numpy())


# -------------------------------------------------------------- 2-D hull
def _hull2d_inputs(seed, n):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 2)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    return pts, key, np.asarray(jax.random.permutation(key, n))


@pytest.mark.parametrize("n,M", [(60, 8), (300, 32)])
@pytest.mark.parametrize("shape", [True, False])
def test_hull2d_plan_matches_jax(n, M, shape):
    pts, key, perm = _hull2d_inputs(n + M, n)
    tplan = hull2d_plan(n, M, shape=shape)
    jplan = J.hull2d_plan(n, M, shape=shape)
    assert tplan.schedule() == jplan.schedule()
    assert tplan.round_bound == jplan.round_bound
    assert tplan.n_nodes == jplan.n_nodes
    wants = [e.compile(jplan)(jnp.asarray(pts), key=key)
             for e in _jax_engines()]
    want = wants[0]
    for other in wants[1:]:
        np.testing.assert_array_equal(np.asarray(other.points),
                                      np.asarray(want.points))
    assert int(want.stats.dropped) == 0
    for eng in _port_engines():
        got = eng.compile(tplan)(pts, key=perm)
        ctx = f"{eng.name} shape={shape}"
        np.testing.assert_array_equal(got.points.numpy(),
                                      np.asarray(want.points), err_msg=ctx)
        assert int(got.count) == int(want.count), ctx
        assert got.count.dtype == torch.int32
        assert_same_accum(want.stats, got.stats, ctx=ctx)
        if eng.name == "kernel":
            assert eng.route_log.dense == 0 and eng.route_log.kernel > 0
    h = int(want.count)
    np.testing.assert_allclose(np.asarray(want.points)[:h],
                               convex_hull_oracle(pts), atol=1e-6)


@pytest.mark.parametrize("shape", [True, False])
def test_hull2d_plan_of_nothing(shape):
    jres = J.LocalEngine().compile(J.hull2d_plan(0, 8, shape=shape))(
        jnp.zeros((0, 2), jnp.float32))
    for eng in _port_engines():
        res = eng.compile(hull2d_plan(0, 8, shape=shape))(
            np.zeros((0, 2), np.float32))
        assert res.points.shape == (0, 2) and int(res.count) == 0
        assert res.count.dtype == torch.int32
        assert_same_accum(jres.stats, res.stats, ctx=eng.name)


def test_hull2d_on_pallas_engine():
    """One hull query on the JAX kernel engine (interpret mode): the port's
    kernel engine routes every shuffle to the kernels and agrees."""
    n, M = 300, 32
    pts, key, perm = _hull2d_inputs(11, n)
    want = J.get_engine("pallas").compile(J.hull2d_plan(n, M))(
        jnp.asarray(pts), key=key)
    eng = get_engine("kernel", device="cpu")
    got = eng.compile(hull2d_plan(n, M))(pts, key=perm)
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(want.points))
    assert int(got.count) == int(want.count)
    assert_same_accum(want.stats, got.stats)
    assert eng.route_log.dense == 0


# -------------------------------------------------------------- 3-D hull
def _cloud(kind, n):
    rng = np.random.default_rng(n)
    if kind == "coplanar":
        return np.concatenate([rng.normal(size=(n, 2)), np.zeros((n, 1))],
                              axis=1).astype(np.float32)
    return rng.normal(size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("kind,n,M", [
    ("gauss", 3, 8), ("gauss", 4, 8), ("gauss", 9, 8), ("gauss", 12, 16),
    ("gauss", 14, 64), ("coplanar", 6, 8), ("coplanar", 10, 16),
])
def test_hull3d_plan_matches_jax(kind, n, M):
    pts = _cloud(kind, n)
    jplan = J.hull3d_plan(n, M)
    want = J.LocalEngine().compile(jplan)(jnp.asarray(pts))
    want_mask = np.asarray(want.mask)
    np.testing.assert_array_equal(np.flatnonzero(want_mask),
                                  convex_hull_3d_oracle(pts))
    for shape in (True, False):
        tplan = hull3d_plan(n, M, shape=shape)
        assert tplan.schedule() == J.hull3d_plan(n, M, shape=shape).schedule()
        assert tplan.round_bound == jplan.round_bound
        assert tplan.n_nodes == jplan.n_nodes
        for eng in _port_engines():
            got = eng.compile(tplan)(pts)
            ctx = f"{eng.name} shape={shape}"
            np.testing.assert_array_equal(got.mask.numpy(), want_mask,
                                          err_msg=ctx)
            assert_same_accum(want.stats, got.stats, ctx=ctx)


@pytest.mark.parametrize("kind,n,M", [
    ("gauss", 2, 8), ("gauss", 5, 8), ("gauss", 13, 16), ("coplanar", 7, 8),
])
def test_dense_hull3d_matches_jax(kind, n, M):
    pts = _cloud(kind, n)
    # jitted (the stats are functional); eager, it compiles op by op
    want = jax.jit(jax_hull3d._hull3d_dense, static_argnums=(1, 2))(
        jnp.asarray(pts), M, 1e-4)
    got = hull3d._hull3d_dense(torch.from_numpy(pts), M, 1e-4)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert_same_accum(want.stats, got.stats)


def test_facet_mask_matches_jax():
    pts = _cloud("gauss", 11)
    want = jax_hull3d._facet_mask(jnp.asarray(pts), jax_combinations(11, 3),
                                  1e-4)
    got = hull3d._facet_mask(torch.from_numpy(pts),
                             combinations_array(11, 3, device="cpu"), 1e-4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -------------------------------------------------------------------- LP
def _lp_inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, d)).astype(np.float32)
    b = rng.uniform(1, 2, n).astype(np.float32)       # origin feasible
    c = rng.normal(size=d).astype(np.float32)
    return c, A, b


LP_CASES = [(10, 2, 0), (8, 3, 1), (7, 4, 2)]       # tests/test_geometry.py
INFEASIBLE = (np.array([1.0, 0.0], np.float32),
              np.array([[1, 0], [-1, 0]], np.float32),
              np.array([-1, -1], np.float32))


def _close_lp(got_x, got_obj, want_x, want_obj, ctx=""):
    want_obj = float(want_obj)
    if not np.isfinite(want_obj):
        assert float(got_obj) == want_obj, ctx
        return
    assert abs(float(got_obj) - want_obj) <= LP_OBJ_RTOL * max(
        1.0, abs(want_obj)), ctx
    np.testing.assert_allclose(np.asarray(got_x), np.asarray(want_x),
                               atol=LP_X_ATOL, err_msg=ctx)


@pytest.mark.parametrize("n,d,seed", LP_CASES)
def test_solve_bases_feasible_set_matches_jax(n, d, seed):
    c, A, b = _lp_inputs(n, d, seed)
    _, want_feas, _ = jax_lp._solve_bases(
        jnp.asarray(c), jnp.asarray(A), jnp.asarray(b),
        jax_combinations(n, d), 1e-5)
    _, got_feas, _ = lp._solve_bases(
        *(torch.from_numpy(v) for v in (c, A, b)),
        combinations_array(n, d, device="cpu"), 1e-5)
    np.testing.assert_array_equal(got_feas.numpy(), np.asarray(want_feas))


@pytest.mark.parametrize("case", LP_CASES + ["infeasible"])
@pytest.mark.parametrize("shape", [True, False])
def test_lp_plan_matches_jax(case, shape):
    if case == "infeasible":
        c, A, b = INFEASIBLE
    else:
        c, A, b = _lp_inputs(*case)
    n, d = A.shape
    M = 16
    jplan = J.lp_plan(n, d, M, shape=shape)
    tplan = lp_plan(n, d, M, shape=shape)
    assert tplan.schedule() == jplan.schedule()
    assert tplan.round_bound == jplan.round_bound
    want = J.LocalEngine().compile(jplan)(jnp.asarray(c), jnp.asarray(A),
                                          jnp.asarray(b))
    for eng in _port_engines():
        got = eng.compile(tplan)(c, A, b)
        ctx = f"{case} {eng.name} shape={shape}"
        _close_lp(got.x, got.objective, want.x, want.objective, ctx)
        assert_same_accum(want.stats, got.stats, ctx=ctx)
    if case != "infeasible":
        _, best = linear_program_oracle(c, A, b)
        assert abs(float(want.objective) - best) < 1e-3


@pytest.mark.parametrize("case", LP_CASES + ["infeasible"])
def test_dense_lp_matches_jax(case):
    if case == "infeasible":
        c, A, b = INFEASIBLE
    else:
        c, A, b = _lp_inputs(*case)
    # jitted (the stats are functional); eager, it compiles op by op
    want = jax.jit(jax_lp._lp_dense, static_argnums=(3, 4))(
        *(jnp.asarray(v) for v in (c, A, b)), 16, 1e-5)
    got = lp._lp_dense(*(torch.from_numpy(v) for v in (c, A, b)), 16, 1e-5)
    _close_lp(got.x, got.objective, want.x, want.objective, str(case))
    assert_same_accum(want.stats, got.stats, ctx=str(case))


# --------------------------------------------------------- host wrappers
def test_convex_hull_2d_raises_on_drops():
    """All points in one x-bucket overflow a reducer sized for a share."""
    pts = np.zeros((64, 2), np.float32)
    pts[:, 1] = np.arange(64)
    with pytest.raises(RuntimeError, match="exceeded mailbox capacity"):
        convex_hull_2d(pts, 8, engine=LocalEngine(device="cpu"), slack=1.0)


@pytest.mark.parametrize("engine", [None, "local"])
def test_host_wrappers_match_jax(engine):
    pts2 = np.random.default_rng(1).normal(size=(100, 2)).astype(np.float32)
    pts3 = _cloud("gauss", 10)
    c, A, b = _lp_inputs(8, 3, 1)
    port = None if engine is None else LocalEngine(device="cpu")
    jeng = None if engine is None else J.LocalEngine()
    jcost, cost = J.MRCost(), MRCost()
    if engine is not None:
        h = convex_hull_2d(pts2, 16, engine=port, cost=cost)
        np.testing.assert_allclose(h, convex_hull_oracle(pts2), atol=1e-6)
        assert h.dtype == np.float64
    got3 = convex_hull_3d(pts3, 16, engine=port, cost=cost, device="cpu")
    want3 = J.convex_hull_3d(pts3, 16, engine=jeng, cost=jcost)
    np.testing.assert_array_equal(got3, want3)
    x, obj = linear_program_nd(c, A, b, 16, engine=port, cost=cost,
                               device="cpu")
    jx, jobj = J.linear_program_nd(c, A, b, 16, engine=jeng, cost=jcost)
    _close_lp(x, obj, jx, jobj)
    assert x.dtype == np.float64 and isinstance(obj, float)
    if engine is None:
        assert (cost.rounds, cost.communication) == (jcost.rounds,
                                                     jcost.communication)
    assert linear_program_nd(*INFEASIBLE, 8, engine=port,
                             device="cpu") == (None, None)


def test_deprecated_wrappers_warn_and_match_the_plans():
    eng = LocalEngine(device="cpu")
    pts2, _, perm = _hull2d_inputs(3, 80)
    pts3 = _cloud("gauss", 9)
    c, A, b = _lp_inputs(10, 2, 0)
    with pytest.warns(DeprecationWarning, match="hull2d_plan"):
        r2 = convex_hull_2d_mr(pts2, 16, engine=eng, key=perm)
    with pytest.warns(DeprecationWarning, match="hull3d_plan"):
        r3 = convex_hull_3d_mr(pts3, 16, engine=eng)
    with pytest.warns(DeprecationWarning, match="hull3d_plan"):
        r3d = convex_hull_3d_mr(pts3, 16, device="cpu")
    with pytest.warns(DeprecationWarning, match="lp_plan"):
        rl = linear_program_mr(c, A, b, 16, engine=eng)
    with pytest.warns(DeprecationWarning, match="lp_plan"):
        rld = linear_program_mr(c, A, b, 16, device="cpu")
    p2 = eng.compile(hull2d_plan(80, 16))(pts2, key=perm)
    assert torch.equal(r2.points, p2.points)
    assert torch.equal(r3.mask, eng.compile(hull3d_plan(9, 16))(pts3).mask)
    assert torch.equal(r3.mask, r3d.mask)
    pl = eng.compile(lp_plan(10, 2, 16))(c, A, b)
    assert torch.equal(rl.objective, pl.objective)
    assert torch.equal(rl.objective, rld.objective)


# ------------------------------------------------------- bounds, helpers
@pytest.mark.parametrize("M", [2, 3, 8, 64, 8192])
def test_round_bounds_match_jax(M):
    for n in (0, 1, 2, 3, 4, 5, 17, 100, 1000, 1 << 20, 1 << 24):
        assert hull_round_bound(n, M) == J.hull_round_bound(n, M), n
        assert hull3d_round_bound(n, M) == J.hull3d_round_bound(n, M), n
        for d in (1, 2, 3, 4):
            if n >= d:
                assert lp_round_bound(n, d, M) == J.lp_round_bound(n, d, M)
    for V in (1, 2, 7, 2048):
        assert hull_round_bound(5000, M, n_nodes=V) == J.hull_round_bound(
            5000, M, n_nodes=V)


@pytest.mark.parametrize("n,k", [(0, 3), (3, 3), (7, 2), (12, 3), (9, 4)])
def test_combinations_array_matches_jax(n, k):
    got = combinations_array(n, k, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_combinations(n, k)))


def test_oracles_match_jax():
    from repro.core.geometry import oracles as jax_oracles
    pts2 = np.random.default_rng(0).normal(size=(50, 2))
    np.testing.assert_array_equal(convex_hull_oracle(pts2),
                                  jax_oracles.convex_hull_oracle(pts2))
    for name in sorted(DEGENERATE_2D):
        p = np.asarray(DEGENERATE_2D[name], np.float64)
        np.testing.assert_array_equal(convex_hull_oracle(p),
                                      jax_oracles.convex_hull_oracle(p))
    pts3 = _cloud("gauss", 9)
    np.testing.assert_array_equal(convex_hull_3d_oracle(pts3),
                                  jax_oracles.convex_hull_3d_oracle(pts3))
    c, A, b = _lp_inputs(8, 3, 1)
    x, obj = linear_program_oracle(c, A, b)
    jx, jobj = jax_oracles.linear_program_oracle(c, A, b)
    np.testing.assert_array_equal(x, jx)
    assert obj == jobj
    assert linear_program_oracle(*INFEASIBLE) == (None, None)


def test_geometry_entry_points_default_to_the_card():
    """The legacy dense paths and the index tables run on the card unless
    asked for the CPU; without CUDA they raise instead of running here."""
    pts3 = _cloud("gauss", 5)
    c, A, b = _lp_inputs(6, 2, 0)
    calls = [lambda: convex_hull_3d_mr(pts3, 8).mask,
             lambda: linear_program_mr(c, A, b, 8).objective,
             lambda: combinations_array(4, 2)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for call in calls:
            if torch.cuda.is_available():
                assert call().device.type == "cuda"
                continue
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            convex_hull_3d(pts3, 8)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            linear_program_nd(c, A, b, 8)


def test_core_exports_every_name_of_the_jax_core():
    """``repro_torch.core`` exports every name ``repro.core`` exports,
    geometry, ``ShardedEngine`` and ``HardwareModel`` (the H100's figures)
    included."""
    import repro_torch.core as T
    assert set(J.__all__) - set(T.__all__) == set()
    assert all(hasattr(T, name) for name in T.__all__)

"""The §4.3 sample sort: the port's plan on its dense and kernel engines vs
the JAX package's ``sort_plan`` on ``LocalEngine()`` and
``get_engine("pallas")``.

The splitter sample is the one random draw, so the port is handed the JAX
package's own draw — ``jax.random.permutation(key, n)`` as indices — and
then every output value and every ``CostAccum`` field must agree exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core import LocalEngine as JaxLocalEngine
from repro.core import MRCost as JaxMRCost
from repro.core import get_engine as jax_get_engine
from repro.core import brute_force_sort as jax_brute_force_sort
from repro.core import quantile_splitters as jax_quantile_splitters
from repro.core import sort_plan as jax_sort_plan
from repro_torch.core import (LocalEngine, MRCost, brute_force_sort,
                              get_engine, pad_batch, quantile_splitters,
                              sample_sort_mr, sort_plan, sort_plan_escalating)
from repro_torch.testing import assert_same_accum


def _jax_draw(seed, n):
    key = jax.random.PRNGKey(seed)
    return key, np.asarray(jax.random.permutation(key, n))


def _port_engines():
    return [LocalEngine(device="cpu"),
            get_engine("kernel", device="cpu")]


@pytest.mark.parametrize("seed,n,M,levels", [
    (0, 300, 16, 1), (1, 500, 32, 1), (2, 1000, 32, 2), (4, 777, 8, 1),
    (5, 1500, 64, 2),
])
def test_sort_plan_matches_jax_local(seed, n, M, levels):
    x = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    key, idx = _jax_draw(seed, n)
    plan = jax_sort_plan(n, M, levels=levels)
    want = JaxLocalEngine().compile(plan)(jnp.asarray(x), key=key)
    assert int(want.stats.dropped) == 0
    tplan = sort_plan(n, M, levels=levels)
    assert tplan.schedule() == plan.schedule()
    assert tplan.round_bound == plan.round_bound
    for eng in _port_engines():
        got = eng.compile(tplan)(x, key=idx)
        np.testing.assert_array_equal(got.values.numpy(),
                                      np.asarray(want.values), err_msg=eng.name)
        assert_same_accum(want.stats, got.stats, ctx=eng.name)


# One levels=2 query (entry, refine and local-sort shuffles): each JAX query
# on the Pallas engine compiles its kernels in interpret mode, about 10 s on
# one CPU core, so levels=1 is held to the JAX package through its dense
# engine above.
@pytest.mark.parametrize("seed,n,M,levels", [(7, 900, 32, 2)])
def test_sort_plan_matches_jax_pallas(seed, n, M, levels):
    x = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    key, idx = _jax_draw(seed, n)
    jeng = jax_get_engine("pallas")
    want = jeng.compile(jax_sort_plan(n, M, levels=levels))(
        jnp.asarray(x), key=key)
    eng = get_engine("kernel", device="cpu")
    got = eng.compile(sort_plan(n, M, levels=levels))(x, key=idx)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    assert_same_accum(want.stats, got.stats)
    # every shuffle of the query took the kernel path, in both packages
    assert eng.route_log.snapshot() == (levels + 1, 0)
    assert jeng.route_log.kernel == levels + 1 and jeng.route_log.dense == 0


def test_overflow_is_reported_like_jax():
    """Duplicate-heavy input at a tight slack: both packages report the
    same drop count (the paper's w.h.p. failure event)."""
    n, M = 600, 16
    x = np.repeat(np.arange(6, dtype=np.float32), 100)
    key, idx = _jax_draw(11, n)
    want = JaxLocalEngine().compile(jax_sort_plan(n, M, slack=1.5))(
        jnp.asarray(x), key=key)
    assert int(want.stats.dropped) > 0
    for eng in _port_engines():
        got = eng.compile(sort_plan(n, M, slack=1.5))(x, key=idx)
        assert_same_accum(want.stats, got.stats, ctx=eng.name)


def test_quantile_splitters_match_jax():
    n = 1000
    x = np.random.default_rng(8).normal(size=n).astype(np.float32)
    key, idx = _jax_draw(8, n)
    want, s = jax_quantile_splitters(jnp.asarray(x), 32, 8, key)
    got, s2 = quantile_splitters(torch.from_numpy(x), 32, 8, idx)
    assert s == s2
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_brute_force_sort_matches_jax():
    x = np.random.default_rng(9).integers(0, 20, 70).astype(np.float32)
    jcost, cost = JaxMRCost(), MRCost()
    want = jax_brute_force_sort(jnp.asarray(x), 16, cost=jcost)
    got = brute_force_sort(torch.from_numpy(x), 16, cost=cost)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert vars(cost) == vars(jcost)


def test_batch_equals_loop_and_cache_counts():
    n, M, B = 256, 16, 3
    eng = get_engine("kernel", device="cpu")
    xs = np.random.default_rng(12).normal(size=(B, n)).astype(np.float32)
    plan = sort_plan(n, M)
    exe = eng.compile(plan)
    assert eng.compile(sort_plan(n, M)) is exe          # equal fingerprint
    info = eng.cache_info()
    assert (info.hits, info.misses, info.currsize) == (1, 1, 1)
    assert eng.compile(sort_plan(n, 2 * M)) is not exe
    assert eng.cache_info().misses == 2
    keys = [5, torch.Generator().manual_seed(6), np.arange(n)[::-1].copy()]
    out = exe.batch(B)(xs, keys=keys)
    assert exe.batch(B) is exe.batch(B)
    keys[1] = torch.Generator().manual_seed(6)           # a fresh generator
    for i in range(B):
        one = exe(xs[i], key=keys[i])
        assert torch.equal(out.values[i], one.values)
        for fb, f1 in zip(out.stats, one.stats):
            assert torch.equal(fb[i], f1)
        assert torch.equal(one.values, torch.sort(torch.from_numpy(xs[i]))
                           .values)
    default = exe.batch(2)(xs[:2])
    assert torch.equal(default.values[1], exe(xs[1], key=8).values)


def test_seeds_are_reproducible_and_inputs_checked():
    n, M = 300, 16
    eng = LocalEngine(device="cpu")
    exe = eng.compile(sort_plan(n, M))
    x = np.random.default_rng(13).normal(size=n).astype(np.float32)
    a, b = exe(x, key=3), exe(x, key=3)
    assert_same_accum(a.stats, b.stats)
    assert torch.equal(a.values, torch.sort(torch.from_numpy(x)).values)
    with pytest.raises(ValueError, match="expected shape"):
        exe(x[:10], key=3)
    with pytest.raises(ValueError, match="expected dtype"):
        exe(x.astype(np.float64), key=3)
    with pytest.raises(ValueError, match="at least"):
        exe(x, key=np.arange(5))
    padded, pkeys, valid = pad_batch((x[None],), 3, keys=np.array([[1, 2]]))
    assert padded[0].shape == (3, n) and pkeys.shape == (3, 2)
    assert valid.tolist() == [True, False, False]


def test_escalation_and_deprecated_wrapper():
    n, M = 400, 16
    eng = LocalEngine(device="cpu")
    x = np.repeat(np.arange(4, dtype=np.float32), 100)
    res = sort_plan_escalating(x, M, key=1, engine=eng)
    assert int(res.stats.dropped) == 0
    assert torch.equal(res.values, torch.from_numpy(np.sort(x)))
    with pytest.warns(DeprecationWarning):
        res = sample_sort_mr(x[:n], M, engine=eng, key=1, slack=8.0)
    assert torch.equal(res.values, torch.from_numpy(np.sort(x)))
    trivial = eng.compile(sort_plan(1, M))(np.ones(1, np.float32))
    assert trivial.values.tolist() == [1.0] and int(trivial.stats.rounds) == 0

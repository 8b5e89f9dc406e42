"""The port's training substrate against the JAX package on the CPU:
``cross_entropy``, AdamW and Adafactor, the warmup-cosine schedule, and
the synthetic data pipeline.

The same numpy inputs go through both packages.  The loss, the optimizer
updates and their states agree within 1e-6; the schedule within 1e-6
relative; the batches and the shuffle permutations bit for bit.  JAX's own
two optimizer convergence tests are mirrored on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import global_shuffle_indices as jax_shuffle
from repro.data import make_pipeline as jax_make_pipeline
from repro.models.layers import cross_entropy as jax_cross_entropy
from repro.optim import (adafactor_init as jax_adafactor_init,
                         adafactor_update as jax_adafactor_update,
                         adamw_init as jax_adamw_init,
                         adamw_update as jax_adamw_update)
from repro.optim.schedule import warmup_cosine as jax_warmup_cosine
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs import get_config
from repro_torch.data import (SyntheticCorpus, global_shuffle_indices,
                              make_pipeline)
from repro_torch.interop import (opt_state_from_numpy, opt_state_to_numpy,
                                 tree_from_numpy)
from repro_torch.models.layers import cross_entropy
from repro_torch.optim import (AdafactorState, AdamWState, adafactor_init,
                               adafactor_update, adamw_init, adamw_update,
                               make_optimizer, warmup_cosine)

TOL = 1e-6


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol, err_msg=what)


def _nest(rng):
    """A params-like nest: stacked 3-D and 2-D matrices, a vector, and a
    1-D leaf of length 1."""
    return {"layers": {"w": rng.normal(size=(3, 6, 5)).astype(np.float32),
                       "scale": rng.normal(size=(3, 5)).astype(np.float32)},
            "embed": {"table": rng.normal(size=(7, 4)).astype(np.float32)},
            "bias": rng.normal(size=(4,)).astype(np.float32),
            "one": rng.normal(size=(1,)).astype(np.float32)}


# --------------------------------------------------------------------- loss
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_cross_entropy_matches_jax(masked, dtype):
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(3, 11, 37)) * 4).astype(np.float32)
    labels = rng.integers(0, 37, (3, 11)).astype(np.int32)
    mask = (rng.random((3, 11)) < 0.6).astype(np.int32) if masked else None
    jl = jnp.asarray(logits)
    tl = torch.from_numpy(logits)
    if dtype == "bfloat16":
        jl, tl = jl.astype(jnp.bfloat16), tl.bfloat16()
    want = jax_cross_entropy(jl, jnp.asarray(labels),
                             None if mask is None else jnp.asarray(mask))
    got = cross_entropy(tl, torch.from_numpy(labels),
                        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == ()
    _close(got, want)


def test_cross_entropy_all_masked_is_zero():
    got = cross_entropy(torch.zeros(2, 3, 5), torch.zeros(2, 3, dtype=torch.int32),
                        torch.zeros(2, 3))
    assert float(got) == 0.0


def test_cross_entropy_gradient_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 5, 9)).astype(np.float32)
    labels = rng.integers(0, 9, (2, 5)).astype(np.int32)
    want = jax.grad(lambda l: jax_cross_entropy(l, jnp.asarray(labels)))(
        jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    cross_entropy(t, torch.from_numpy(labels)).backward()
    _close(t.grad, want)


# --------------------------------------------------------------- optimizers
def _run_both(init_j, update_j, init_t, update_t, steps=3, **kw):
    """``steps`` updates of one random nest and random gradients through
    both packages; yields (step, JAX (params, state), port (params, state))
    as numpy."""
    rng = np.random.default_rng(3)
    params = _nest(rng)
    jp = tree_map(jnp.asarray, params)
    js = init_j(jp)
    tp = tree_from_numpy(params)
    ts = init_t(tp)
    for step in range(steps):
        g = tree_map(lambda a: (rng.normal(size=a.shape) * 2.0)
                     .astype(np.float32), params)
        lr = 1e-2 * (step + 1)
        jp, js = update_j(tree_map(jnp.asarray, g), js, jp, lr, **kw)
        tp, ts = update_t(tree_from_numpy(g), ts, tp,
                          torch.tensor(lr, dtype=torch.float32), **kw)
        yield step, (jp, js), (tp, ts)


def _compare(j, t, what):
    (jp, js), (tp, ts) = j, t
    for a, b in zip(tree_leaves(tree_map(np.asarray, jp)), tree_leaves(tp)):
        _close(b, a, what=f"{what}: params")
    assert type(ts)._fields == type(js)._fields
    for name, fj, ft in zip(js._fields, js, ts):
        lj, lt = tree_leaves(tree_map(np.asarray, fj)), tree_leaves(ft)
        assert len(lj) == len(lt)
        for a, b in zip(lj, lt):
            assert tuple(a.shape) == tuple(b.shape), (what, name)
            assert str(a.dtype) == str(b.dtype).replace("torch.", ""), \
                (what, name, a.dtype, b.dtype)
            _close(b, a, what=f"{what}: state.{name}")


@pytest.mark.parametrize("kw", [{}, {"weight_decay": 0.0, "grad_clip": 0.5},
                                {"b1": 0.8, "b2": 0.99, "eps": 1e-6}])
def test_adamw_matches_jax_over_three_steps(kw):
    for step, j, t in _run_both(jax_adamw_init, jax_adamw_update, adamw_init,
                                adamw_update, **kw):
        _compare(j, t, f"adamw step {step}")
    assert isinstance(t[1], AdamWState) and int(t[1].step) == 3


@pytest.mark.parametrize("kw", [{}, {"weight_decay": 0.1,
                                     "clip_threshold": 0.5}])
def test_adafactor_matches_jax_over_three_steps(kw):
    for step, j, t in _run_both(jax_adafactor_init, jax_adafactor_update,
                                adafactor_init, adafactor_update, **kw):
        _compare(j, t, f"adafactor step {step}")
    assert isinstance(t[1], AdafactorState) and int(t[1].step) == 3


def test_updates_happen_in_place():
    """The parameters and the moments are the caller's tensors, updated
    under no_grad; a parameter that requires grad stays a leaf."""
    p = {"w": torch.nn.Parameter(torch.ones(3, 2))}
    st = adamw_init(p)
    m0, w0 = st.m["w"], p["w"]
    p2, st2 = adamw_update({"w": torch.ones(3, 2)}, st, p, 0.1)
    assert p2["w"] is w0 and st2.m["w"] is m0 and w0.is_leaf
    assert bool((w0 < 1).all()) and int(st2.step) == 1


def _quad_problem():
    params = {"a": {"w": torch.tensor([[1.0, -2.0], [3.0, 0.5]])},
              "b": torch.tensor([0.3, -0.1])}

    def loss(p):
        return (torch.sum(torch.square(p["a"]["w"] - 1.0))
                + torch.sum(torch.square(p["b"] + 2.0)))
    return params, loss


def _grad(loss, params):
    leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
    it = iter(leaves)
    nest = tree_map(lambda _: next(it), params)
    grads = torch.autograd.grad(loss(nest), leaves)
    it = iter(grads)
    return tree_map(lambda _: next(it), params)


def test_adamw_converges():
    params, loss = _quad_problem()
    state = adamw_init(params)
    for _ in range(300):
        params, state = adamw_update(_grad(loss, params), state, params,
                                     lr=0.05, weight_decay=0.0)
    assert float(loss(params)) < 1e-2


def test_adafactor_converges():
    params, loss = _quad_problem()
    state = adafactor_init(params)
    for _ in range(400):
        params, state = adafactor_update(_grad(loss, params), state, params,
                                         lr=0.05)
    assert float(loss(params)) < 5e-2


def test_make_optimizer_by_config():
    cfg = get_config("tinyllama-1.1b", reduced=True)
    assert make_optimizer(cfg).name == "adamw"
    import dataclasses
    assert make_optimizer(dataclasses.replace(
        cfg, optimizer="adafactor")).update is adafactor_update
    with pytest.raises(ValueError):
        make_optimizer(dataclasses.replace(cfg, optimizer="sgd"))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_opt_state_round_trips_through_numpy(name):
    """A JAX optimizer state read into numpy becomes the port's, and goes
    back with the same fields, shapes, dtypes and values."""
    params = _nest(np.random.default_rng(4))
    init = {"adamw": jax_adamw_init, "adafactor": jax_adafactor_init}[name]
    js = tree_map(np.asarray, init(tree_map(jnp.asarray, params)))
    js = js._replace(step=np.int32(7))
    ts = opt_state_from_numpy(js, device="cpu")
    assert type(ts) is {"adamw": AdamWState, "adafactor": AdafactorState}[name]
    back = opt_state_to_numpy(ts)
    assert back._fields == js._fields
    for a, b in zip(tree_leaves(tree_map(np.asarray, js)),
                    tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert int(ts.step) == 7 and ts.step.dtype == torch.int32
    with pytest.raises(ValueError, match="fields"):
        opt_state_from_numpy({"step": 0, "m": 1, "v": 2}, device="cpu")


# ----------------------------------------------------------------- schedule
@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (2, 8)])
def test_warmup_cosine_matches_jax(warmup, total):
    steps = np.arange(0, 121, dtype=np.int32)
    want = jax.vmap(lambda s: jax_warmup_cosine(
        s, peak_lr=3e-4, warmup_steps=warmup, total_steps=total))(
            jnp.asarray(steps))
    got = torch.stack([warmup_cosine(torch.tensor(int(s), dtype=torch.int32),
                                     peak_lr=3e-4, warmup_steps=warmup,
                                     total_steps=total) for s in steps])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    assert float(warmup_cosine(0, peak_lr=1.0, warmup_steps=10,
                               total_steps=100)) == 0.0


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("arch,batch,seq,seed", [
    ("tinyllama-1.1b", 4, 32, 3), ("zamba2-1.2b", 2, 17, 0),
    ("rwkv6-1.6b", 3, 8, 11)])
def test_batch_at_is_the_jax_batch(arch, batch, seq, seed):
    jp = jax_make_pipeline(jax_get_config(arch, reduced=True), batch, seq,
                           seed=seed)
    tp = make_pipeline(get_config(arch, reduced=True), batch, seq, seed=seed)
    for step in (0, 1, 17):
        want, got = jp.batch_at(step), tp.batch_at(step)
        assert sorted(want) == sorted(got)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(next(iter(tp))["tokens"],
                                  jp.batch_at(0)["tokens"])


def test_corpus_tokens_are_the_jax_tokens():
    from repro.data import SyntheticCorpus as JaxCorpus
    for kw in ({}, {"order_weight": 0.0}, {"zipf_a": 1.1, "seed": 5}):
        np.testing.assert_array_equal(
            SyntheticCorpus(1000, **kw).tokens(2000, 3),
            JaxCorpus(1000, **kw).tokens(2000, 3))


@pytest.mark.parametrize("paper", [False, True])
@pytest.mark.parametrize("n,seed", [(500, 1), (3000, 7)])
def test_global_shuffle_indices_are_the_jax_permutation(paper, n, seed):
    want = jax_shuffle(n, seed=seed, paper_shuffle=paper)
    got = global_shuffle_indices(n, seed=seed, paper_shuffle=paper,
                                 device="cpu")
    np.testing.assert_array_equal(np.sort(got), np.arange(n))
    np.testing.assert_array_equal(got, want)

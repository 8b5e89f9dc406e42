"""The port's MoE layer and MoE LMs (``repro_torch.models.moe``, the MoE
family of ``DecoderLM``) against the JAX package on the CPU.

The same seeded numpy inputs, and the JAX ``init`` params carried over by
``repro_torch.interop``, go through each JAX function and its port.
Tolerances as tests/test_torch_lm.py: 2e-4 (rtol and atol) in float32,
2e-2 in bfloat16 (there of each element and of the output's rms); routes (``ids``), positions, ``dropped_frac`` and
``pos`` exactly.  The JAX models run eagerly (no ``jax.jit``): at these
sizes that is faster than compiling them.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import moe as jm
from repro_torch.configs import get_config
from repro_torch.interop import (lm_params_from_numpy, lm_params_to_numpy,
                                 tree_from_numpy)
from repro_torch.models import build_model, layers as tl, moe as tm
from repro_torch.testing import moe_layer_f32, scaled_close

RNG = np.random.default_rng(2025)
TOL = 2e-4
MOE = ["kimi-k2-1t-a32b", "llama4-scout-17b-a16e"]


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _close_bf16(got, want, tol=2e-2, what=""):
    """Within ``tol`` of each element and of the reference's rms: a
    bfloat16 output that sums terms of the output's size carries their
    rounding on an element near 0 too."""
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.sqrt(np.mean(want ** 2))))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * scale, err_msg=what)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _normal(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def _cfgs(arch="kimi-k2-1t-a32b", **kw):
    return (jax_get_config(arch, reduced=True, **kw),
            get_config(arch, reduced=True, **kw))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def moe_params():
    """arch -> one MoE layer's params from the JAX ``init_moe`` (numpy)."""
    out = {}
    for arch in MOE:
        jcfg, _ = _cfgs(arch)
        out[arch] = jax.tree_util.tree_map(
            np.asarray, jm.init_moe(jax.random.PRNGKey(1), jcfg))
    return out


@pytest.fixture(scope="module")
def lm_params():
    """arch -> the JAX model's ``init`` params (numpy), built once."""
    return {arch: jax.tree_util.tree_map(
        np.asarray, jax_build_model(_cfgs(arch)[0]).init(
            jax.random.PRNGKey(0))) for arch in MOE}


# ------------------------------------------------------------------- init
@pytest.mark.parametrize("arch", MOE)
def test_init_moe_names_shapes_dtypes_and_std(arch, moe_params):
    _, tcfg = _cfgs(arch)
    gen = torch.Generator().manual_seed(0)
    got = tm.init_moe(gen, tcfg)
    want = moe_params[arch]
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda a: 0, want)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0,
                                                            got))
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        assert tuple(g.shape) == w.shape and \
            str(g.dtype).split(".")[1] == str(w.dtype), path
    assert abs(got["router"].std().item() - 0.02) < 0.002
    e = tcfg.n_experts
    for name in ("w_gate", "w_up", "w_down"):   # fan-in: the expert axis
        assert abs(got[name].std().item() * math.sqrt(e) - 1) < 0.05, name


def test_chunked_init_keeps_the_distribution(monkeypatch):
    """A tensor past ``_INIT_CHUNK`` elements is drawn a block of rows at a
    time, straight into its dtype; smaller ones draw as before."""
    cfg = get_config("kimi-k2-1t-a32b", reduced=True,
                     param_dtype="bfloat16")
    small = tl._dense_init(torch.Generator().manual_seed(3), (64, 96),
                           torch.bfloat16, lead=(2,))
    monkeypatch.setattr(tl, "_INIT_CHUNK", 5000)
    again = tl._dense_init(torch.Generator().manual_seed(3), (64, 96),
                           torch.bfloat16, lead=(2,))
    assert again.dtype == torch.bfloat16 and again.shape == (2, 64, 96)
    assert abs(again.float().std().item() * 8 - 1) < 0.05
    p = tm.init_moe(torch.Generator().manual_seed(0), cfg, lead=(2,))
    for name in ("w_gate", "w_up", "w_down"):
        w = p[name].float()
        assert p[name].dtype == torch.bfloat16
        assert abs(w.std().item() * math.sqrt(cfg.n_experts) - 1) < 0.05
        assert abs(w.mean().item()) < 0.01
    # each block its own draw: no two experts repeat
    assert not torch.equal(p["w_gate"][0, 0], p["w_gate"][0, 1])
    monkeypatch.setattr(tl, "_INIT_CHUNK", 1 << 28)
    assert torch.equal(small, tl._dense_init(
        torch.Generator().manual_seed(3), (64, 96), torch.bfloat16,
        lead=(2,)))


# ----------------------------------------------------------------- router
@pytest.mark.parametrize("arch", MOE)
def test_router_matches_jax_with_ties_to_the_lower_id(arch, moe_params):
    jcfg, tcfg = _cfgs(arch)
    p = moe_params[arch]
    x = _normal(3, 7, tcfg.d_model)
    x[1, 2:5] = 0.0                      # zero tokens: all probabilities tie
    jids, jw, jaux = jm._router(_jnp(p), jcfg, jnp.asarray(x))
    ids, w, aux = tm._router(tree_from_numpy(p), tcfg, _t(x))
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(ids[1, 2].numpy(),
                                  np.arange(tcfg.top_k))
    _close(w, jw, what="weights")
    _close(aux, jaux, what="aux")


# ------------------------------------------------------- einsum dispatch
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("arch", MOE)
def test_moe_einsum_matches_jax(arch, cf, shared, dtype, moe_params):
    """Capacity drops at 1.25, none at 8; group 16 over 2 x 13 tokens pads
    the last group with zero tokens, whose tied routes enter
    ``dropped_frac`` and ``aux``."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=cf, shared_expert=shared,
                       compute_dtype=dtype)
    p = dict(moe_params[arch])           # both configs have a shared expert
    if not shared:
        del p["shared"]
    x = _normal(2, 13, tcfg.d_model)
    jx, tx = jnp.asarray(x).astype(dtype), _t(x).to(getattr(torch, dtype))
    for group in (512, 16):
        want = jm._moe_einsum(_jnp(p), jcfg, jx, group=group)
        got = tm._moe_einsum(tree_from_numpy(p), tcfg, tx, group=group)
        assert got.y.dtype == tx.dtype and got.y.shape == tx.shape
        (_close if dtype == "float32" else _close_bf16)(
            got.y.float(), np.asarray(want.y, np.float32),
            what=f"y, group {group}")
        assert got.dropped_frac.item() == float(want.dropped_frac), group
        _close(got.aux_loss, want.aux_loss, what="aux")
    # the routes and positions themselves, at the padded grouping
    r = tm._route_tokens(tree_from_numpy(p), tcfg, tx, group=16)
    assert r.xg.shape == (2, 16, tcfg.d_model) and r.cap == max(
        1, math.ceil(16 * tcfg.top_k / tcfg.n_experts * cf))
    assert (r.ids[1, 10:] == torch.arange(tcfg.top_k,
                                          dtype=torch.int32)).all()
    if cf == 1.25 and arch == MOE[0]:
        assert 0 < got.dropped_frac.item()


@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("arch", MOE)
def test_float32_expert_loop_matches_the_einsum_dispatch(arch, cf,
                                                         moe_params):
    """``testing.moe_layer_f32``, the reference the card holds the bf16
    layer to, equals the float32 einsum dispatch on the same routes (drops
    at cf 1.25, a padded last group); a lost choice, a lost expert and,
    at top_k > 1, weights left out each fail ``scaled_close`` at 2e-2."""
    _, tcfg = _cfgs(arch, capacity_factor=cf)
    p = tree_from_numpy(moe_params[arch])
    x = _t(_normal(2, 13, tcfg.d_model))
    r = tm._route_tokens(p, tcfg, x, group=16)
    want = tm._moe_einsum(p, tcfg, x, group=16).y
    _close(moe_layer_f32(p, tcfg, x, r), want)
    assert scaled_close(moe_layer_f32(p, tcfg, x, r), want, 2e-2)
    caught = ["last_choice", "expert0"] + ["unweighted"] * (tcfg.top_k > 1)
    for fault in caught:
        bad = moe_layer_f32(p, tcfg, x, r, fault=fault)
        assert not scaled_close(bad, want, 2e-2), fault


def test_apply_moe_picks_the_dispatch(moe_params):
    """Without an expert group the shuffle dispatch is the einsum one."""
    _, tcfg = _cfgs()
    p = tree_from_numpy(moe_params[MOE[0]])
    x = _t(_normal(2, 5, tcfg.d_model))
    want = tm._moe_einsum(p, tcfg, x)
    for dispatch in ("einsum", "shuffle"):
        got = tm.apply_moe(p, dataclasses.replace(tcfg,
                                                  moe_dispatch=dispatch), x)
        assert torch.equal(got.y, want.y)
        assert got.dropped_frac.item() == want.dropped_frac.item()


# ------------------------------------------------------------------ models
@pytest.mark.parametrize("arch", MOE)
def test_moe_params_round_trip(arch, lm_params):
    _, tcfg = _cfgs(arch)
    tree = lm_params[arch]
    model = lm_params_from_numpy(tree, tcfg, device="cpu")
    assert "moe" in model["layers"] and "mlp" not in model["layers"]
    back = lm_params_to_numpy(model)
    flat = jax.tree_util.tree_leaves_with_path(tree)
    assert {".".join(e.key for e in path) for path, _ in flat} == \
        {n for n, _ in model.named_parameters()}
    for path, leaf in flat:
        got = back
        for e in path:
            got = got[e.key]
        assert got.dtype == leaf.dtype
        np.testing.assert_array_equal(got, leaf)
    built = lm_params_to_numpy(build_model(tcfg, device="cpu", seed=2))
    assert jax.tree_util.tree_structure(built) == \
        jax.tree_util.tree_structure(tree)


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_match_jax(arch, impl, lm_params):
    jcfg, tcfg = _cfgs(arch, attn_impl=impl)
    jmodel = jax_build_model(jcfg)
    tree = lm_params[arch]
    jparams = _jnp(tree)
    tmodel = lm_params_from_numpy(tree, tcfg, device="cpu")
    B, S, max_len = 2, 8, 12
    prompt = RNG.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    jlog, jst = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt),
                                         "max_len": max_len})
    tlog, tst = tmodel.prefill(_t(prompt), max_len)
    _close(tlog, jlog, what="prefill logits")
    _close(tst.k, jst.k, what="k cache")
    _close(tst.v, jst.v, what="v cache")
    np.testing.assert_array_equal(tst.pos.numpy(), np.asarray(jst.pos))
    for step in range(3):
        tok = RNG.integers(0, tcfg.vocab_size, B).astype(np.int32)
        jlog, jst = jmodel.decode_step(jparams, jnp.asarray(tok), jst)
        tlog, tst = tmodel.decode_step(_t(tok), tst)
        _close(tlog, jlog, what=f"decode {step} logits")
        _close(tst.k, jst.k, what=f"decode {step} k cache")
        np.testing.assert_array_equal(tst.pos.numpy(), np.asarray(jst.pos))


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("arch", MOE)
def test_loss_fn_matches_jax(arch, impl, lm_params):
    """ce + 0.01 aux, with the metrics {"ce", "aux"}; and the gradient
    reaches every expert parameter (on the CPU the flash path is the
    kernel's plain version, which autograd differentiates)."""
    jcfg, tcfg = _cfgs(arch, attn_impl=impl)
    tree = lm_params[arch]
    tokens = RNG.integers(0, tcfg.vocab_size, (2, 9)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    jloss, jm_ = jax_build_model(jcfg).loss_fn(_jnp(tree), _jnp(batch))
    tmodel = lm_params_from_numpy(tree, tcfg, device="cpu")
    loss, metrics = tmodel.loss_fn(batch)
    assert set(metrics) == {"ce", "aux"}
    _close(loss.detach(), jloss, what="loss")
    _close(metrics["ce"].detach(), jm_["ce"], what="ce")
    _close(metrics["aux"].detach(), jm_["aux"], what="aux")
    assert metrics["aux"].item() > 0
    loss.backward()
    for name in ("router", "w_gate", "w_up", "w_down"):
        g = tmodel["layers"]["moe"][name].grad
        assert g is not None and torch.isfinite(g).all() and g.abs().sum() > 0


def test_serve_engine_matches_the_jax_engine(lm_params):
    """Both engines with the same slot layout give the same tokens.  At
    decode the einsum dispatch groups the B slots, idle ones (their pad
    token) included, so a request's MoE output depends on its neighbours:
    the comparison is of whole engines, never of one request alone."""
    from repro.serve import Request as JRequest
    from repro.serve import ServeConfig as JServeConfig
    from repro.serve import ServeEngine as JServeEngine
    from repro_torch.serve import Request, ServeConfig, ServeEngine
    jcfg, tcfg = _cfgs()
    tree = lm_params[MOE[0]]
    prompts = [RNG.integers(0, tcfg.vocab_size, n).astype(np.int32)
               for n in (3, 5, 4)]
    jeng = JServeEngine(jcfg, _jnp(tree), JServeConfig(max_batch=2,
                                                       max_len=16))
    teng = ServeEngine(lm_params_from_numpy(tree, tcfg, device="cpu"),
                       ServeConfig(max_batch=2, max_len=16))
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(uid=i, prompt=p, max_new_tokens=4))
        teng.submit(Request(uid=i, prompt=p, max_new_tokens=4))
    jdone = {r.uid: r.output for r in jeng.run_until_drained()}
    tdone = {r.uid: r.output for r in teng.run_until_drained()}
    assert tdone == jdone

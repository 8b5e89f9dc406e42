"""The port's encoder-decoder family (``EncDecLM`` over whisper-base's
config) and its cross-attention against the JAX package on the CPU.

The JAX ``init`` params go over with ``repro_torch.interop``; the same
seeded numpy frames and prompts go through both.  Tolerance 2e-4 (rtol and
atol) in float32, as tests/test_torch_lm.py; ``pos`` exactly; the port's
prefill against its own token-by-token decode within 2e-3, the property
tests/test_arch_smoke.py holds the JAX package to.  The JAX model runs
under ``jax.jit`` (eager, it compiles op by op: several times slower).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import layers as jl
from repro_torch.configs import get_config
from repro_torch.interop import (lm_params_from_numpy, lm_params_to_numpy,
                                 tree_from_numpy)
from repro_torch.models import EncDecLM, EncDecState, build_model
from repro_torch.models import layers as tl

ARCH = "whisper-base"
RNG = np.random.default_rng(2027)
TOL = 2e-4


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _cfgs(**kw):
    return (jax_get_config(ARCH, reduced=True, **kw),
            get_config(ARCH, reduced=True, **kw))


@pytest.fixture(scope="module")
def tree():
    return jax.tree_util.tree_map(np.asarray, jax_build_model(
        _cfgs()[0]).init(jax.random.PRNGKey(0)))


def _frames(cfg, b, n=None):
    return (RNG.normal(size=(b, n or cfg.n_frames, cfg.d_model))
            * 0.5).astype(np.float32)


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("impl,s", [("xla", 5), ("flash", 5), ("flash", 1),
                                    ("xla", 1)])
def test_cross_attention_and_cross_kv_match_jax(impl, s):
    """More than one query reaches the flash kernel with s_q != s_k; one
    query takes the einsum path, as in JAX."""
    jcfg, tcfg = _cfgs(attn_impl=impl)
    d, h, kvh, hd = tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads, tcfg.hd
    p = {"wq": RNG.normal(size=(d, h * hd)) * d ** -0.5,
         "wk": RNG.normal(size=(d, kvh * hd)) * d ** -0.5,
         "wv": RNG.normal(size=(d, kvh * hd)) * d ** -0.5,
         "wo": RNG.normal(size=(h * hd, d)) * (h * hd) ** -0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    enc = _frames(tcfg, 2, 23)
    x = RNG.normal(size=(2, s, d)).astype(np.float32)
    jk, jv = jl.init_cross_kv(_jnp(p), jcfg, jnp.asarray(enc))
    tk, tv = tl.init_cross_kv(tree_from_numpy(p), tcfg, _t(enc))
    assert tk.shape == (2, 23, kvh, hd)
    _close(tk, jk, what="k")
    _close(tv, jv, what="v")
    want = jl.cross_attention(_jnp(p), jcfg, jnp.asarray(x), jk, jv)
    got = tl.cross_attention(tree_from_numpy(p), tcfg, _t(x), tk, tv)
    _close(got, want, what="y")


# ------------------------------------------------------------------ models
def test_encdec_params_round_trip_and_init(tree):
    _, tcfg = _cfgs()
    model = lm_params_from_numpy(tree, tcfg, device="cpu")
    assert isinstance(model, EncDecLM)
    names = {".".join(str(getattr(e, "key", getattr(e, "idx", None)))
                      for e in path)
             for path, _ in jax.tree_util.tree_leaves_with_path(tree)}
    assert names == {n for n, _ in model.named_parameters()}
    back = lm_params_to_numpy(model)
    assert isinstance(back["enc"], list) and len(back["dec"]) == \
        tcfg.n_layers
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(tree),
                            jax.tree_util.tree_leaves(back)):
        assert g.dtype == w.dtype, path
        np.testing.assert_array_equal(g, w)
    built = lm_params_to_numpy(build_model(tcfg, device="cpu", seed=5))
    assert jax.tree_util.tree_structure(built) == \
        jax.tree_util.tree_structure(tree)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(tree),
                            jax.tree_util.tree_leaves(built)):
        assert g.shape == w.shape and g.dtype == w.dtype, path
    assert (built["dec"][0]["mlp"]["b_up"] == 0).all()
    assert (built["enc"][1]["attn_norm"]["scale"] == 1).all()


def test_encode_matches_jax(tree):
    jcfg, tcfg = _cfgs(attn_impl="flash")
    frames = _frames(tcfg, 2)
    jmodel = jax_build_model(jcfg)
    # the JAX package's encode is a closure of build_encdec: reach it
    # through prefill's cross K/V, and the port's directly
    model = lm_params_from_numpy(tree, tcfg, device="cpu")
    enc = model.encode(_t(frames))
    assert enc.shape == frames.shape
    prompt = RNG.integers(0, tcfg.vocab_size, (2, 3)).astype(np.int32)
    _, jst = jax.jit(jmodel.prefill)(_jnp(tree), {
        "tokens": jnp.asarray(prompt), "frames": jnp.asarray(frames)})
    P = model.compute_params()[0]
    for i, lp in enumerate(P["dec"]):
        k, v = tl.init_cross_kv(lp["xattn"], tcfg, enc)
        _close(k, jst.cross_k[i], what=f"cross k {i}")
        _close(v, jst.cross_v[i], what=f"cross v {i}")


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_prefill_and_decode_match_jax(impl, tree):
    jcfg, tcfg = _cfgs(attn_impl=impl)
    jmodel = jax_build_model(jcfg)
    jparams = _jnp(tree)
    model = lm_params_from_numpy(tree, tcfg, device="cpu")
    B, S, max_len = 2, 6, 10
    prompt = RNG.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    frames = _frames(tcfg, B)
    jlog, jst = jax.jit(lambda p, b: jmodel.prefill(
        p, {**b, "max_len": max_len}))(jparams, {
            "tokens": jnp.asarray(prompt), "frames": jnp.asarray(frames)})
    tlog, tst = model.prefill(_t(prompt), _t(frames), max_len)
    assert isinstance(tst, EncDecState)
    _close(tlog, jlog, what="prefill logits")
    for name in ("self_k", "self_v", "cross_k", "cross_v"):
        _close(getattr(tst, name), getattr(jst, name), what=name)
    np.testing.assert_array_equal(tst.pos.numpy(), np.asarray(jst.pos))
    decode = jax.jit(jmodel.decode_step)
    for step in range(3):
        tok = RNG.integers(0, tcfg.vocab_size, B).astype(np.int32)
        jlog, jst = decode(jparams, jnp.asarray(tok), jst)
        tlog, tst = model.decode_step(_t(tok), tst)
        _close(tlog, jlog, what=f"decode {step} logits")
        _close(tst.self_k, jst.self_k, what=f"decode {step} self_k")
        np.testing.assert_array_equal(tst.pos.numpy(), np.asarray(jst.pos))


def test_loss_fn_matches_jax(tree):
    jcfg, tcfg = _cfgs()
    tokens = RNG.integers(0, tcfg.vocab_size, (2, 7)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
             "frames": _frames(tcfg, 2),
             "loss_mask": (RNG.random((2, 6)) > 0.3).astype(np.float32)}
    jloss, jmet = jax.jit(jax_build_model(jcfg).loss_fn)(_jnp(tree),
                                                         _jnp(batch))
    model = lm_params_from_numpy(tree, tcfg, device="cpu")
    loss, met = model.loss_fn(batch)
    assert set(met) == {"ce"}
    _close(loss.detach(), jloss, what="loss")
    loss.backward()
    for g in (model["enc"][0]["attn"]["wq"].grad,
              model["dec"][1]["xattn"]["wk"].grad,
              model["dec"][0]["mlp"]["b_up"].grad):
        assert g is not None and g.abs().sum() > 0


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_prefill_equals_token_by_token_decode(impl):
    """tests/test_arch_smoke.py's property: decode from a zeroed state that
    holds prefill's cross K/V gives prefill's logits."""
    cfg = get_config(ARCH, reduced=True, attn_impl=impl)
    model = build_model(cfg, device="cpu", seed=1)
    prompt = torch.from_numpy(RNG.integers(0, cfg.vocab_size, (2, 8)))
    frames = _t(_frames(cfg, 2) * 0.04)
    logits_p, state_p = model.prefill(prompt, frames, 16)
    state = model.init_decode_state(2, 16)._replace(
        cross_k=state_p.cross_k, cross_v=state_p.cross_v)
    for t in range(8):
        logits_d, state = model.decode_step(prompt[:, t], state)
    _close(logits_d, logits_p, 2e-3)
    _close(state.self_k[:, :, :8], state_p.self_k[:, :, :8], 2e-3)


def test_prefill_takes_a_frame_count_other_than_n_frames():
    cfg = get_config(ARCH, reduced=True)
    model = build_model(cfg, device="cpu")
    _, st = model.prefill(torch.zeros((1, 2), dtype=torch.int32),
                          _t(_frames(cfg, 1, 7)))
    assert st.cross_k.shape[2] == 7
    logits, st = model.decode_step(torch.zeros(1, dtype=torch.int32), st)
    assert torch.isfinite(logits).all() and int(st.pos[0]) == 3

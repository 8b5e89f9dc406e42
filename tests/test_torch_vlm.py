"""The port's VLM family (``DecoderLM`` over internvl2-2b's config: the
projected patch embeddings before the token embeddings) against the JAX
package on the CPU.

The JAX ``init`` params go over with ``repro_torch.interop``; the same
seeded numpy prompts and patch embeddings go through both.  Tolerance
2e-4 (rtol and atol) in float32, as tests/test_torch_lm.py; ``pos``
exactly.  The JAX model runs eagerly (no ``jax.jit``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.interop import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeConfig, ServeEngine

ARCH = "internvl2-2b"
RNG = np.random.default_rng(2026)
TOL = 2e-4


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def tree():
    cfg = jax_get_config(ARCH, reduced=True)
    return jax.tree_util.tree_map(
        np.asarray, jax_build_model(cfg).init(jax.random.PRNGKey(0)))


def _patches(cfg, b):
    return (RNG.normal(size=(b, cfg.n_patches, cfg.d_model)) * 0.5).astype(
        np.float32)


def test_vlm_params_round_trip(tree):
    cfg = get_config(ARCH, reduced=True)
    model = lm_params_from_numpy(tree, cfg, device="cpu")
    back = lm_params_to_numpy(model)
    assert set(back) == set(tree) and "vision_proj" in back
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        got = back
        for e in path:
            got = got[e.key]
        assert got.dtype == leaf.dtype
        np.testing.assert_array_equal(got, leaf)
    built = lm_params_to_numpy(build_model(cfg, device="cpu", seed=4))
    assert jax.tree_util.tree_structure(built) == \
        jax.tree_util.tree_structure(tree)
    w = built["vision_proj"]["w"]
    assert w.shape == (cfg.d_model, cfg.d_model)
    assert abs(w.std() - 0.02) < 0.003


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_prefill_and_decode_match_jax(impl, tree):
    jcfg = jax_get_config(ARCH, reduced=True, attn_impl=impl)
    tcfg = get_config(ARCH, reduced=True, attn_impl=impl)
    jmodel = jax_build_model(jcfg)
    jparams = _jnp(tree)
    model = lm_params_from_numpy(tree, tcfg, device="cpu")
    B, S = 2, 6
    max_len = tcfg.n_patches + S + 4
    prompt = RNG.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    pe = _patches(tcfg, B)
    jlog, jst = jmodel.prefill(jparams, {
        "tokens": jnp.asarray(prompt), "patch_embeds": jnp.asarray(pe),
        "max_len": max_len})
    tlog, tst = model.prefill(_t(prompt), max_len, patch_embeds=_t(pe))
    _close(tlog, jlog, what="prefill logits")
    _close(tst.k, jst.k, what="k cache")
    _close(tst.v, jst.v, what="v cache")
    np.testing.assert_array_equal(tst.pos.numpy(), np.asarray(jst.pos))
    assert int(tst.pos[0]) == tcfg.n_patches + S
    for step in range(3):
        tok = RNG.integers(0, tcfg.vocab_size, B).astype(np.int32)
        jlog, jst = jmodel.decode_step(jparams, jnp.asarray(tok), jst)
        tlog, tst = model.decode_step(_t(tok), tst)
        _close(tlog, jlog, what=f"decode {step} logits")
        _close(tst.v, jst.v, what=f"decode {step} v cache")
        np.testing.assert_array_equal(tst.pos.numpy(), np.asarray(jst.pos))


def test_loss_fn_matches_jax_on_the_text_positions(tree):
    jcfg = jax_get_config(ARCH, reduced=True)
    tcfg = get_config(ARCH, reduced=True)
    tokens = RNG.integers(0, tcfg.vocab_size, (2, 7)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
             "patch_embeds": _patches(tcfg, 2)}
    jloss, jmet = jax_build_model(jcfg).loss_fn(_jnp(tree), _jnp(batch))
    model = lm_params_from_numpy(tree, tcfg, device="cpu")
    loss, met = model.loss_fn(batch)
    _close(loss.detach(), jloss, what="loss")
    _close(met["ce"].detach(), jmet["ce"], what="ce")
    assert met["aux"].item() == 0.0 == float(jmet["aux"])
    loss.backward()
    g = model["vision_proj"]["w"].grad
    assert g is not None and g.abs().sum() > 0


def test_vlm_needs_patch_embeds():
    cfg = get_config(ARCH, reduced=True)
    model = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="patch_embeds"):
        model.prefill(torch.zeros((1, 4), dtype=torch.int32))


def test_serve_engine_serves_the_text_like_jax(tree):
    """The VLM's text served by both engines (decode steps only, as the
    JAX engine does): the same tokens for the same requests."""
    from repro.serve import Request as JRequest
    from repro.serve import ServeConfig as JServeConfig
    from repro.serve import ServeEngine as JServeEngine
    jcfg = jax_get_config(ARCH, reduced=True)
    tcfg = get_config(ARCH, reduced=True)
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

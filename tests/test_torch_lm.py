"""The port's LM slice against the JAX package on the CPU.

The same seeded numpy inputs (and, for models, the JAX ``model.init``
params carried over by ``repro_torch.interop``) go through each JAX
function and its port.  The JAX flash kernel runs in interpret mode; the
port's ``kernels.ops.flash_attention`` takes its plain version on CPU
tensors.  Tolerances: 2e-4 (rtol and atol) in float32, the flash kernel
test's own (``tests/test_kernels.py``), and 2e-2 in bfloat16; integer
outputs and ``pos`` exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jax_ops
from repro.models import build_model as jax_build_model
from repro.models import layers as jl
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.interop import (lm_params_from_numpy, lm_params_to_numpy,
                                 tree_from_numpy)
from repro_torch.kernels import ops, ref
from repro_torch._tree import tree_map
from repro_torch.models import DecoderLM, build_model, layers as tl

RNG = np.random.default_rng(2024)
TOL = 2e-4
DENSE = ["tinyllama-1.1b", "qwen1.5-0.5b", "olmo-1b", "granite-8b"]


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _normal(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def _jax_params_np(cfg, seed=0):
    params = jax_build_model(cfg).init(jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, params)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_configs_copy_the_jax_package(arch, reduced):
    assert tuple(ARCH_IDS) == tuple(JAX_ARCH_IDS)
    want = jax_get_config(arch, reduced=reduced)
    got = get_config(arch, reduced=reduced)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.padded_vocab == want.padded_vocab
    assert got.n_params() == want.n_params()


# ---------------------------------------------------------- flash attention
@pytest.mark.parametrize("b,hq,hkv,s,d,causal,dtype", [
    (2, 4, 2, 128, 64, True, "float32"),
    (1, 2, 2, 200, 32, False, "float32"),    # ragged tiles, key masking
    (1, 8, 2, 256, 64, True, "float32"),
    (1, 2, 1, 100, 48, True, "float32"),     # MQA, head dim not 2^k
    (2, 4, 4, 64, 128, False, "float32"),
    (1, 8, 2, 128, 64, True, "bfloat16"),
])
def test_flash_attention_matches_jax(b, hq, hkv, s, d, causal, dtype):
    q, k, v = (_normal(b, h, s, d) for h in (hq, hkv, hkv))
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    want = jax_ops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                   block_k=64)
    tq, tk, tv = (_t(a).to(getattr(torch, dtype)) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == (b, hq, s, d)
    tol = TOL if dtype == "float32" else 2e-2
    _close(got.float(), np.asarray(want, np.float32), tol)
    # and the oracle over the broadcast heads
    g = hq // hkv
    oracle = ref.flash_attention_ref(
        tq.reshape(b * hq, s, d),
        tk.repeat_interleave(g, 1).reshape(b * hq, s, d),
        tv.repeat_interleave(g, 1).reshape(b * hq, s, d), causal=causal)
    _close(got.float(), oracle.float().reshape(b, hq, s, d), tol)


def test_flash_attention_decode_shape_matches_jax():
    """One query against a 512-key cache (the serve-step pattern)."""
    q, k, v = _normal(2, 4, 1, 64), _normal(2, 4, 512, 64), \
        _normal(2, 4, 512, 64)
    want = jax_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=False, block_q=64,
                                   block_k=128)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=False)
    _close(got, want)


def test_flash_attention_rejects_bad_heads():
    q, k = torch.zeros(1, 3, 4, 8), torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="GQA"):
        ops.flash_attention(q, k, k)


# ------------------------------------------------------------------- layers
def _cfg(arch="tinyllama-1.1b", **kw):
    return (jax_get_config(arch, reduced=True, **kw),
            get_config(arch, reduced=True, **kw))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_apply_norm_matches_jax(kind):
    jcfg, tcfg = _cfg()
    d = tcfg.d_model
    x = _normal(2, 5, d, scale=3.0) + 0.5
    p = {"scale": _normal(d) + 1.0, "bias": _normal(d)}
    p = {"rmsnorm": {"scale": p["scale"]}, "layernorm": p,
         "nonparam_ln": {}}[kind]
    want = jl.apply_norm(jax.tree_util.tree_map(jnp.asarray, p), jcfg,
                         jnp.asarray(x), kind=kind)
    got = tl.apply_norm(tree_from_numpy(p), tcfg, _t(x), kind=kind)
    _close(got, want)


@pytest.mark.parametrize("hd,theta", [(8, 10000.0), (16, 500000.0)])
def test_rope_matches_jax(hd, theta):
    x = _normal(2, 7, 3, hd)
    pos = RNG.integers(0, 4096, (2, 7)).astype(np.int32)
    want = jl.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tl.rope(_t(x), _t(pos), theta)
    _close(got, want)


@pytest.mark.parametrize("act,bias", [("silu", False), ("silu", True),
                                      ("gelu", True)])
def test_apply_mlp_matches_jax(act, bias):
    jcfg, tcfg = _cfg(act=act)
    d, f = tcfg.d_model, tcfg.d_ff
    p = {"w_up": _normal(d, f, scale=d ** -0.5),
         "w_down": _normal(f, d, scale=f ** -0.5)}
    if act == "silu":
        p["w_gate"] = _normal(d, f, scale=d ** -0.5)
    if bias:
        p["b_up"], p["b_down"] = _normal(f), _normal(d)
    x = _normal(2, 3, d)
    want = jl.apply_mlp(jax.tree_util.tree_map(jnp.asarray, p), jcfg,
                        jnp.asarray(x))
    got = tl.apply_mlp(tree_from_numpy(p), tcfg, _t(x))
    _close(got, want)


@pytest.mark.parametrize("tied", [False, True])
def test_apply_lm_head_masks_padded_vocab_like_jax(tied):
    jcfg, tcfg = _cfg(vocab_size=250, tie_embeddings=tied)
    assert tcfg.padded_vocab == 256
    d = tcfg.d_model
    head = {"w": _normal(d, 256, scale=d ** -0.5)}
    embed = {"table": _normal(256, d, scale=0.02)}
    x = _normal(2, 1, d)
    want = jl.apply_lm_head(jax.tree_util.tree_map(jnp.asarray, head), jcfg,
                            jnp.asarray(x),
                            embed=jax.tree_util.tree_map(jnp.asarray, embed))
    got = tl.apply_lm_head(tree_from_numpy(head), tcfg, _t(x),
                           embed=tree_from_numpy(embed))
    _close(got, want)
    assert (got[..., 250:] == -1e30).all()


def _attn_params(cfg):
    d, hd, h, kvh = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    p = {"wq": _normal(d, h * hd, scale=d ** -0.5),
         "wk": _normal(d, kvh * hd, scale=d ** -0.5),
         "wv": _normal(d, kvh * hd, scale=d ** -0.5),
         "wo": _normal(h * hd, d, scale=(h * hd) ** -0.5)}
    if cfg.qkv_bias:
        p.update(bq=_normal(h * hd), bk=_normal(kvh * hd),
                 bv=_normal(kvh * hd))
    return p


@pytest.mark.parametrize("arch", [
    "tinyllama-1.1b",        # MQA (reduced: 8 heads, 1 KV head)
    "qwen1.5-0.5b",          # QKV biases
    "granite-8b",            # GQA 2:1
])
def test_attention_decode_matches_jax_with_the_clamp(arch):
    """pos = max_len - 1 writes the last slot; pos = max_len is clamped by
    JAX's dynamic_update_slice onto it as well."""
    jcfg, tcfg = _cfg(arch)
    T = 12
    p = _attn_params(tcfg)
    x = _normal(4, 1, tcfg.d_model)
    ck = _normal(4, T, tcfg.n_kv_heads, tcfg.hd)
    cv = _normal(4, T, tcfg.n_kv_heads, tcfg.hd)
    pos = np.array([0, 5, T - 1, T], np.int32)
    jy, jk, jv = jl.attention_decode(
        jax.tree_util.tree_map(jnp.asarray, p), jcfg, jnp.asarray(x),
        jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos))
    tk, tv = _t(ck).clone(), _t(cv).clone()
    ty, gk, gv = tl.attention_decode(tree_from_numpy(p), tcfg, _t(x), tk, tv,
                                     _t(pos))
    assert gk is tk and gv is tv           # written in place
    _close(ty, jy, what="y")
    _close(gk, jk, what="cache_k")
    _close(gv, jv, what="cache_v")
    # rows 2 and 3 both wrote slot T - 1, and nothing else moved
    assert not np.allclose(gk[3, T - 1].numpy(), ck[3, T - 1])
    np.testing.assert_array_equal(gk[3, :T - 1].numpy(), ck[3, :T - 1])


@pytest.mark.parametrize("impl", ["einsum", "chunked"])
def test_sdpa_paths_match_jax(impl):
    jcfg, tcfg = _cfg()
    q = _normal(2, 40, tcfg.n_heads, tcfg.hd)
    k, v = (_normal(2, 40, tcfg.n_kv_heads, tcfg.hd) for _ in range(2))
    jfn, tfn = ((jl._sdpa_einsum, tl._sdpa_einsum) if impl == "einsum" else
                (lambda *a, **kw: jl._sdpa_chunked(*a, chunk=16, **kw),
                 lambda *a, **kw: tl._sdpa_chunked(*a, chunk=16, **kw)))
    want = jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True,
               q_offset=3)
    got = tfn(_t(q), _t(k), _t(v), True, q_offset=3)
    _close(got, want)


# ------------------------------------------------------------------- models
def test_lm_params_round_trip_and_names():
    jcfg, tcfg = _cfg()
    tree = _jax_params_np(jcfg)
    model = lm_params_from_numpy(tree, tcfg, device="cpu")
    back = lm_params_to_numpy(model)
    flat_j = jax.tree_util.tree_leaves_with_path(tree)
    names = {".".join(e.key for e in path) for path, _ in flat_j}
    assert names == {n for n, _ in model.named_parameters()}
    for path, leaf in flat_j:
        got = back
        for e in path:
            got = got[e.key]
        assert got.dtype == leaf.dtype
        np.testing.assert_array_equal(got, leaf)


@pytest.mark.parametrize("arch", DENSE)
def test_build_model_draws_like_jax_init(arch):
    """Same names, shapes and dtypes as the JAX init, and the same
    distributions (embed std 0.02, projections 1/sqrt(fan_in))."""
    jcfg, tcfg = _cfg(arch)
    want = _jax_params_np(jcfg)
    got = lm_params_to_numpy(build_model(tcfg, device="cpu", seed=3))
    ws = jax.tree_util.tree_leaves_with_path(want)
    gs = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in ws] == [p for p, _ in gs]
    for (path, w), (_, g) in zip(ws, gs):
        assert w.shape == g.shape and w.dtype == g.dtype, path
    assert abs(got["embed"]["table"].std() - 0.02) < 0.002
    wq = got["layers"]["attn"]["wq"]
    assert abs(wq.std() * np.sqrt(wq.shape[1]) - 1.0) < 0.1


@pytest.mark.parametrize("impl", ["flash", "xla"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax(arch, impl):
    jcfg, tcfg = _cfg(arch, attn_impl=impl)
    jmodel = jax_build_model(jcfg)
    tree = _jax_params_np(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tmodel = lm_params_from_numpy(tree, tcfg, device="cpu")
    B, S, max_len = 2, 8, 16
    prompt = RNG.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    jl_, jst = jax.jit(lambda p, tok: jmodel.prefill(
        p, {"tokens": tok, "max_len": max_len}))(jparams, jnp.asarray(prompt))
    tl_, tst = tmodel.prefill(_t(prompt), max_len)
    _close(tl_, jl_, what="prefill logits")
    _close(tst.k, jst.k, what="k cache")
    _close(tst.v, jst.v, what="v cache")
    assert tst.pos.dtype == torch.int32
    np.testing.assert_array_equal(tst.pos.numpy(), np.asarray(jst.pos))
    decode = jax.jit(jmodel.decode_step)
    for step in range(3):
        tok = RNG.integers(0, tcfg.vocab_size, B).astype(np.int32)
        jl_, jst = decode(jparams, jnp.asarray(tok), jst)
        tl_, tst = tmodel.decode_step(_t(tok), tst)
        _close(tl_, jl_, what=f"decode {step} logits")
        _close(tst.k, jst.k, what=f"decode {step} k cache")
        np.testing.assert_array_equal(tst.pos.numpy(), np.asarray(jst.pos))


def test_port_prefill_equals_token_by_token_decode():
    """The property tests/test_arch_smoke.py holds the JAX package to."""
    cfg = get_config("tinyllama-1.1b", reduced=True, attn_impl="flash")
    model = build_model(cfg, device="cpu", seed=1)
    prompt = torch.from_numpy(RNG.integers(0, cfg.vocab_size, (2, 8)))
    logits_p, state_p = model.prefill(prompt, 16)
    state = model.init_decode_state(2, 16)
    for t in range(8):
        logits_d, state = model.decode_step(prompt[:, t], state)
    _close(logits_p, logits_d, 2e-3)
    _close(state_p.k, state.k, 2e-3)


@pytest.mark.parametrize("change", ["load_state_dict", "in_place",
                                    "to_dtype"])
def test_compute_copy_follows_parameter_changes(change):
    """The compute-dtype copy of the weights is made again after the
    parameters change: prefill then equals a model built from the new
    weights.  In bfloat16, where the copy does not alias the float32
    parameters."""
    cfg = get_config("tinyllama-1.1b", reduced=True, compute_dtype="bfloat16")
    model = build_model(cfg, device="cpu", seed=1)
    prompt = torch.from_numpy(RNG.integers(0, cfg.vocab_size, (2, 6)))
    before, _ = model.prefill(prompt)
    if change == "load_state_dict":
        sd = model.state_dict()
        sd["layers.mlp.w_down"] = sd["layers.mlp.w_down"] * 2.0
        model.load_state_dict(sd)
    elif change == "in_place":                  # as an optimizer step does
        with torch.no_grad():                   # the params are trainable
            model["layers"]["mlp"]["w_down"].mul_(2.0)
    else:
        model.double()
        assert model.compute_params()[0]["final_norm"]["scale"].dtype == \
            torch.float64
    fresh = DecoderLM(cfg, tree_map(lambda a: a.clone(), model.param_tree()))
    after, _ = model.prefill(prompt)
    want, _ = fresh.prefill(prompt)
    assert torch.equal(after, want)
    if change != "to_dtype":
        assert not torch.allclose(after, before)


def test_unknown_family_raises():
    cfg = get_config("tinyllama-1.1b", reduced=True, family="retnet")
    with pytest.raises(ValueError, match="unknown model family"):
        build_model(cfg, device="cpu")

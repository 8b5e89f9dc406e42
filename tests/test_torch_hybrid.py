"""The port's hybrid (zamba2) and RWKV6 LMs against the JAX package on the
CPU.

Both packages get the same params (the JAX ``model.init`` carried over by
``repro_torch.interop``, every leaf perturbed with seeded numpy noise so a
leaf read wrongly shows) and the same prompts, of a length that is not a
multiple of the chunk.  Float32 logits and every decode-state field agree
within 2e-4, ``pos`` exactly.  Under bfloat16 compute the two frameworks
round at different places (XLA keeps excess precision inside its fusions),
so each output may differ from the JAX package's by at most twice the JAX
package's own bfloat16 error against its float32 model.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.interop import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import (HybridLM, RWKVLM, build_model,
                                model_class)

RNG = np.random.default_rng(77)
TOL = 2e-4
ARCHS = ["zamba2-1.2b", "rwkv6-1.6b"]
#: leaves the JAX package reads in float32 or the param dtype, never cast
#: to the compute dtype
KEPT = {"zamba2-1.2b": ("A_log", "D", "dt_bias", "norm_scale"),
        "rwkv6-1.6b": ("w0", "w_lora_a", "w_lora_b", "u", "ln_x_scale")}


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _cfgs(arch, **kw):
    return (jax_get_config(arch, reduced=True, **kw),
            get_config(arch, reduced=True, **kw))


def _params(jcfg, seed=0):
    """The JAX init, every float leaf moved by seeded noise (A_log, D, u,
    the norm scales, ... are constants at init)."""
    tree = jax.tree_util.tree_map(
        np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    return jax.tree_util.tree_map(
        lambda a: (a + rng.normal(size=a.shape) * 0.1 * (np.abs(a).mean()
                                                         + 0.5))
        .astype(a.dtype), tree)


def _copy(out):
    logits, state = out
    return logits, type(state)(*(t.clone() for t in state))


def _run_both(jcfg, tcfg, tree, prompt, max_len, steps):
    """Prefill then ``steps`` decode steps in both packages; yields
    (what, JAX (logits, state), port (logits, state)) after each, the
    port's state copied (its decode steps update the buffers in place)."""
    jmodel = jax_build_model(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tmodel = lm_params_from_numpy(tree, tcfg, device="cpu")
    jout = jax.jit(lambda p, tok: jmodel.prefill(
        p, {"tokens": tok, "max_len": max_len}))(jparams, jnp.asarray(prompt))
    tout = tmodel.prefill(_t(prompt), max_len)
    yield "prefill", jout, _copy(tout)
    decode = jax.jit(jmodel.decode_step)
    rng = np.random.default_rng(5)
    for step in range(steps):
        tok = rng.integers(0, tcfg.vocab_size, prompt.shape[0]) \
            .astype(np.int32)
        jout = decode(jparams, jnp.asarray(tok), jout[1])
        tout = tmodel.decode_step(_t(tok), tout[1])
        yield f"decode {step}", jout, _copy(tout)


# ------------------------------------------------------------------ building
@pytest.mark.parametrize("arch,cls", [("zamba2-1.2b", HybridLM),
                                      ("rwkv6-1.6b", RWKVLM)])
def test_build_model_draws_like_jax_init(arch, cls):
    """The family's class, with the JAX init's names, shapes and dtypes."""
    jcfg, tcfg = _cfgs(arch)
    want = jax.tree_util.tree_map(np.asarray, jax_build_model(jcfg).init(
        jax.random.PRNGKey(0)))
    model = build_model(tcfg, device="cpu", seed=3)
    assert type(model) is cls is model_class(tcfg)
    got = lm_params_to_numpy(model)
    ws = jax.tree_util.tree_leaves_with_path(want)
    gs = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in ws] == [p for p, _ in gs]
    for (path, w), (_, g) in zip(ws, gs):
        assert w.shape == g.shape and w.dtype == g.dtype, path


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_round_trip(arch):
    jcfg, tcfg = _cfgs(arch)
    tree = _params(jcfg)
    model = lm_params_from_numpy(tree, tcfg, device="cpu")
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


def test_model_refuses_another_family():
    _, tcfg = _cfgs("zamba2-1.2b")
    tree = lm_params_to_numpy(build_model(tcfg, device="cpu"))
    with pytest.raises(ValueError, match="serves family 'ssm'"):
        RWKVLM(tcfg, tree)


# ----------------------------------------------------------- float32 parity
@pytest.mark.parametrize("arch,impl", [("zamba2-1.2b", "flash"),
                                       ("zamba2-1.2b", "xla"),
                                       ("rwkv6-1.6b", "xla")])
def test_prefill_and_decode_match_jax(arch, impl):
    """Logits and every decode-state field, after prefill of 13 tokens
    (chunk 8) and after each of 3 decode steps."""
    jcfg, tcfg = _cfgs(arch, attn_impl=impl)
    prompt = RNG.integers(0, tcfg.vocab_size, (2, 13)).astype(np.int32)
    for what, (jl, jst), (tl, tst) in _run_both(jcfg, tcfg, _params(jcfg),
                                                prompt, 20, 3):
        _close(tl, jl, what=f"{what} logits")
        assert tst._fields == jst._fields
        for name, g, w in zip(tst._fields, tst, jst):
            assert tuple(g.shape) == w.shape, (what, name)
            if name == "pos":
                assert g.dtype == torch.int32
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            else:
                _close(g, w, what=f"{what} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_port_prefill_equals_token_by_token_decode(arch):
    """The property tests/test_arch_smoke.py holds the JAX package to."""
    cfg = get_config(arch, reduced=True, attn_impl="flash")
    model = build_model(cfg, device="cpu", seed=1)
    prompt = torch.from_numpy(RNG.integers(0, cfg.vocab_size, (2, 11)))
    logits_p, state_p = model.prefill(prompt, 16)
    state = model.init_decode_state(2, 16)
    for t in range(11):
        logits_d, state = model.decode_step(prompt[:, t], state)
    _close(logits_p, logits_d, 2e-3)
    for name, a, b in zip(state._fields, state_p, state):
        _close(a, b, 2e-3, what=name)


# ---------------------------------------------------------- bfloat16 parity
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_compute_matches_jax(arch):
    """compute_dtype bfloat16: each output within twice the JAX package's
    own bfloat16 error against its float32 model, and the compute copy
    keeps what the JAX package never casts in its stored dtype."""
    jcfg, tcfg = _cfgs(arch, compute_dtype="bfloat16")
    tree = _params(jcfg)
    prompt = RNG.integers(0, tcfg.vocab_size, (2, 13)).astype(np.int32)
    runs = list(_run_both(jcfg, tcfg, tree, prompt, 20, 3))
    ref = _run_both(dataclasses.replace(jcfg, compute_dtype="float32"),
                    dataclasses.replace(tcfg, compute_dtype="float32"),
                    tree, prompt, 20, 3)
    for (what, (jl, jst), (tl, tst)), (_, (rl, rst), _) in zip(runs, ref):
        assert tl.dtype == torch.bfloat16
        for name, g, w, r in zip(("logits",) + tst._fields, (tl, *tst),
                                 (jl, *jst), (rl, *rst)):
            err, own = (np.abs(_f32(g) - _f32(w)).max(),
                        np.abs(_f32(w) - _f32(r)).max())
            assert err <= 2 * own, (what, name, err, own)
    model = lm_params_from_numpy(tree, tcfg, device="cpu")
    P, layers = model.compute_params()
    block = layers[0]["mamba"] if arch == "zamba2-1.2b" else \
        layers[0]["time"]
    for name in KEPT[arch]:
        assert block[name].dtype == torch.float32, name
    assert P["embed"]["table"].dtype == torch.bfloat16
    assert P["final_norm"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("arch,cast,kept", [
    ("tinyllama-1.1b", ["embed.table", "lm_head.w", "layers.attn.wq",
                        "layers.mlp.w_gate"],
     ["final_norm.scale", "layers.attn_norm.scale"]),
    ("zamba2-1.2b", ["embed.table", "lm_head.w", "shared.attn.wo",
                     "shared.mlp.w_up", "layers.mamba.in_proj",
                     "layers.mamba.conv_w", "layers.mamba.out_proj"],
     ["final_norm.scale", "shared.attn_norm.scale", "layers.norm.scale",
      "layers.mamba.A_log", "layers.mamba.D", "layers.mamba.dt_bias",
      "layers.mamba.norm_scale"]),
    ("rwkv6-1.6b", ["embed.table", "layers.time.mu", "layers.time.receptance",
                    "layers.time.key", "layers.time.value",
                    "layers.time.gate", "layers.time.output",
                    "layers.chan.mu", "layers.chan.wk", "layers.chan.wv",
                    "layers.chan.wr"],
     ["final_norm.bias", "layers.ln1.scale", "layers.ln2.bias",
      "layers.time.w0", "layers.time.w_lora_a", "layers.time.w_lora_b",
      "layers.time.u", "layers.time.ln_x_scale"]),
])
def test_compute_copy_casts_what_jax_casts(arch, cast, kept):
    cfg = get_config(arch, reduced=True, compute_dtype="bfloat16")
    P, _ = build_model(cfg, device="cpu").compute_params()

    def leaf(path):
        node = P
        for k in path.split("."):
            node = node[k]
        return node
    for path in cast:
        assert leaf(path).dtype == torch.bfloat16, path
    for path in kept:
        assert leaf(path).dtype == torch.float32, path


# -------------------------------------------------------------------- serve
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_cpu(arch, capsys):
    serve_main(["--arch", arch, "--reduced", "--device", "cpu",
                "--requests", "5", "--max-batch", "2", "--new-tokens", "4",
                "--prompt-len", "11"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["requests"] == 5 and stats["tokens"] == 20

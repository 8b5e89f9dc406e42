"""The port's training path against the JAX package on the CPU.

The same params (the JAX init, every leaf moved by seeded numpy noise) and
the same batches go through both packages.  The loss and every gradient
leaf of ``loss_fn`` agree, for reduced tinyllama, zamba2 and rwkv6, within
``max|d| <= 2e-4 * max(1, max|g_jax|)`` per leaf; so do the Mamba2 block's
and RWKV6 time mixing's gradients (the RWKV6 backward raised before: its
ratio tensor was updated in place).  Four ``Trainer`` steps from the JAX
trainer's initial params give the JAX trainer's losses within 1e-4
relative and its params within ``2 * peak_lr * steps``.  A checkpoint the
JAX trainer wrote restores into the port bit for bit (and back); the port
restarts exactly (1e-5, JAX's own rule); a trained checkpoint serves.
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
from repro.models import rwkv as jax_rwkv
from repro.models import ssm as jax_ssm
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import Trainer as JaxTrainer
from repro.train import checkpoint as jax_ckpt
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs import get_config
from repro_torch.interop import lm_params_from_numpy, to_numpy
from repro_torch.launch.train import main as train_main
from repro_torch.models import build_model, model_class
from repro_torch.models import rwkv, ssm
from repro_torch.serve import Request, ServeConfig, ServeEngine
from repro_torch.train import Trainer, TrainConfig, build_train_step
from repro_torch.train import checkpoint as ckpt

ARCHS = ["tinyllama-1.1b", "zamba2-1.2b", "rwkv6-1.6b"]
GRAD_TOL = 2e-4


def _t(a):
    return torch.from_numpy(np.array(a))


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


def _batch(cfg, b, s, seed=0, mask=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if mask:
        batch["loss_mask"] = (rng.random((b, s)) < 0.7).astype(np.int32)
    return batch


def _grads_close(got, want, what):
    """Per leaf: max|got - want| <= GRAD_TOL * max(1, max|want|)."""
    paths = jax.tree_util.tree_leaves_with_path(want)
    for (path, w), g in zip(paths, tree_leaves(got)):
        w = np.asarray(w, np.float64)
        g = np.asarray(g, np.float64)
        assert g.shape == w.shape, (what, path)
        err = np.abs(g - w).max()
        bound = GRAD_TOL * max(1.0, np.abs(w).max())
        assert err <= bound, (what, jax.tree_util.keystr(path), err, bound)


def _port_grads(model):
    return tree_map(lambda p: p.grad.detach().clone(),
                    model.trainable_tree())


# -------------------------------------------------------------- the blocks
def test_rwkv_time_mixing_backpropagates_like_jax():
    """A backward through ``apply_rwkv_time`` (which used to raise: the
    ratio tensor autograd saved was updated in place) gives JAX's gradients
    for every parameter and the input, over 13 tokens in chunks of 8."""
    jcfg = jax_get_config("rwkv6-1.6b", reduced=True)
    tcfg = get_config("rwkv6-1.6b", reduced=True)
    p = jax.tree_util.tree_map(lambda a: a[0], _params(jcfg)["layers"]
                               )["time"]
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 13, tcfg.d_model)).astype(np.float32)
    w = rng.normal(size=(2, 13, tcfg.d_model)).astype(np.float32)

    def f(p_, x_):
        return jnp.sum(jax_rwkv.apply_rwkv_time(p_, jcfg, x_, chunk=8) * w)
    want_p, want_x = jax.jit(jax.grad(f, argnums=(0, 1)))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    tp = tree_map(lambda a: _t(a).requires_grad_(), p)
    tx = _t(x).requires_grad_()
    (rwkv.apply_rwkv_time(tp, tcfg, tx, chunk=8) * _t(w)).sum().backward()
    _grads_close(tree_map(lambda a: a.grad, tp), want_p, "rwkv time")
    _grads_close([tx.grad], [want_x], "rwkv time dx")
    with torch.no_grad():                   # serving keeps the in-place form
        y = rwkv.apply_rwkv_time(tp, tcfg, tx, chunk=8)
    assert not y.requires_grad


def test_mamba_block_gradients_match_jax():
    jcfg = jax_get_config("zamba2-1.2b", reduced=True)
    tcfg = get_config("zamba2-1.2b", reduced=True)
    p = jax.tree_util.tree_map(lambda a: a[0], _params(jcfg)["layers"]
                               )["mamba"]
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 13, tcfg.d_model)).astype(np.float32)
    w = rng.normal(size=(2, 13, tcfg.d_model)).astype(np.float32)

    def f(p_, x_):
        return jnp.sum(jax_ssm.apply_mamba(p_, jcfg, x_) * w)
    want_p, want_x = jax.jit(jax.grad(f, argnums=(0, 1)))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    tp = tree_map(lambda a: _t(a).requires_grad_(), p)
    tx = _t(x).requires_grad_()
    (ssm.apply_mamba(tp, tcfg, tx) * _t(w)).sum().backward()
    grads = tree_map(lambda a: a.grad, tp)
    _grads_close(grads, want_p, "mamba")
    _grads_close([tx.grad], [want_x], "mamba dx")
    assert all(bool(g.abs().sum() > 0) for g in tree_leaves(grads))


def test_mamba_backward_stays_finite_where_the_decay_overflows():
    """At chunk 128 with strong decay, exp(cum_i - cum_j) above the
    diagonal overflows.  The JAX package masks the product after the exp,
    so its backward multiplies the masked-off inf by 0 and gives NaN; the
    port masks before the exp: the same output, finite gradients, and
    JAX's gradients wherever those are finite."""
    jcfg = dataclasses.replace(jax_get_config("zamba2-1.2b", reduced=True),
                               ssm_chunk=128)
    tcfg = dataclasses.replace(get_config("zamba2-1.2b", reduced=True),
                               ssm_chunk=128)
    p = jax.tree_util.tree_map(lambda a: a[0], _params(jcfg)["layers"]
                               )["mamba"]
    p["A_log"] = np.full_like(p["A_log"], 2.0)          # a_t about e^-5
    x = np.random.default_rng(8).normal(
        size=(2, 128, tcfg.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    # jitted, as the other gradient tests here: eager, the chunk-128 scan
    # compiles op by op
    want_y = jax.jit(lambda p_: jax_ssm.apply_mamba(p_, jcfg,
                                                    jnp.asarray(x)))(jp)
    want_g = jax.jit(jax.grad(lambda p_: jnp.sum(jax_ssm.apply_mamba(
        p_, jcfg, jnp.asarray(x)))))(jp)
    assert any(np.isnan(np.asarray(g)).any()
               for g in jax.tree_util.tree_leaves(want_g))
    tp = tree_map(lambda a: _t(a).requires_grad_(), p)
    y = ssm.apply_mamba(tp, tcfg, _t(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=2e-4, atol=2e-4)
    y.sum().backward()
    for name, w in want_g.items():
        g = tp[name].grad
        assert bool(torch.isfinite(g).all()), name
        if np.isfinite(np.asarray(w)).all():
            _grads_close([g], [w], f"mamba {name}")


# ------------------------------------------------------------ whole models
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch, mask):
    """``loss_fn`` and the gradient of every leaf, over 13 tokens (not a
    multiple of the chunk), with and without a loss mask."""
    jcfg = jax_get_config(arch, reduced=True)
    tcfg = get_config(arch, reduced=True)
    tree = _params(jcfg)
    batch = _batch(tcfg, 2, 13, mask=mask)
    jmodel = jax_build_model(jcfg)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss_fn, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, tree),
            {k: jnp.asarray(v) for k, v in batch.items()})
    model = lm_params_from_numpy(tree, tcfg, device="cpu")
    loss, met = model.loss_fn(batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert sorted(met) == sorted(jmet)
    np.testing.assert_allclose(met["ce"].item(), float(jmet["ce"]),
                               rtol=1e-5)
    _grads_close(_port_grads(model), jgrads, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_give_the_same_gradients(arch):
    """Per-layer checkpointing recomputes the layers in the backward and
    changes nothing else (for RWKV6 only under scan_layers, as in JAX)."""
    tcfg = get_config(arch, reduced=True)
    tree = to_numpy(build_model(tcfg, device="cpu", seed=2).param_tree())
    batch = _batch(tcfg, 2, 11, seed=3)
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        model = lm_params_from_numpy(tree, cfg, device="cpu")
        loss, _ = model.loss_fn(batch)
        loss.backward()
        out[remat] = (loss.item(), _port_grads(model))
    for remat in ("full", "dots"):
        assert out[remat][0] == out["none"][0]
        for a, b in zip(tree_leaves(out[remat][1]),
                        tree_leaves(out["none"][1])):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_flash_impl_on_the_cpu_trains_like_xla():
    """On the CPU ``attn_impl="flash"`` takes the plain attention, which
    autograd differentiates: the same loss and gradients as ``"xla"`` (on
    the card the flash kernel has no backward and raises)."""
    tcfg = get_config("tinyllama-1.1b", reduced=True)
    tree = to_numpy(build_model(tcfg, device="cpu", seed=6).param_tree())
    batch = _batch(tcfg, 2, 12, seed=7)
    out = []
    for impl in ("xla", "flash"):
        model = lm_params_from_numpy(
            tree, dataclasses.replace(tcfg, attn_impl=impl), device="cpu")
        loss, _ = model.loss_fn(batch)
        loss.backward()
        out.append((loss.item(), _port_grads(model)))
    assert abs(out[0][0] - out[1][0]) < 1e-6
    for a, b in zip(tree_leaves(out[0][1]), tree_leaves(out[1][1])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_remat_recomputes_the_layers():
    """Under remat "full" each layer's forward runs again in the backward:
    the zamba2 scan runs twice per layer, once without remat."""
    from repro_torch.kernels import ops
    calls = []
    real = ops.ssm_scan

    def counting(a, x):
        calls.append(a.shape)
        return real(a, x)
    tcfg = get_config("zamba2-1.2b", reduced=True)
    batch = _batch(tcfg, 2, 16)
    ops.ssm_scan = counting
    try:
        for remat, want in (("none", 1), ("full", 2)):
            calls.clear()
            model = build_model(dataclasses.replace(tcfg, remat=remat),
                                device="cpu")
            model.loss_fn(batch)[0].backward()
            assert len(calls) == want * tcfg.n_layers, remat
    finally:
        ops.ssm_scan = real


def test_bf16_compute_loss_is_close_and_grads_reach_float32_params():
    """bfloat16 compute casts inside the graph: every gradient lands on
    the float32 parameters, and the loss stays near the float32 one."""
    tcfg = get_config("zamba2-1.2b", reduced=True, compute_dtype="bfloat16")
    model = build_model(tcfg, device="cpu", seed=4)
    batch = _batch(tcfg, 2, 16)
    loss, _ = model.loss_fn(batch)
    loss.backward()
    ref = model_class(tcfg)(dataclasses.replace(
        tcfg, compute_dtype="float32"), model.param_tree())
    assert abs(loss.item() - ref.loss_fn(batch)[0].item()) < 0.05
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None, name
        assert p.grad.dtype == torch.float32, name


# ------------------------------------------------------------------ trainer
def _tcs(arch, steps, **kw):
    jcfg = jax_get_config(arch, reduced=True)
    tcfg = get_config(arch, reduced=True)
    common = dict(global_batch=4, seq_len=16, steps=steps, warmup_steps=2,
                  log_every=1, seed=5, **kw)
    return JaxTrainConfig(arch=jcfg, **common), TrainConfig(arch=tcfg,
                                                            **common)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_steps_match_the_jax_trainer(arch):
    """Four steps from the JAX trainer's initial params: the same losses
    within 1e-4 relative, params within 2 * peak_lr * steps."""
    steps = 4
    jtc, ttc = _tcs(arch, steps)
    jt = JaxTrainer(jtc)
    init = jax.tree_util.tree_map(np.array, jt.params)
    tt = Trainer(ttc, device="cpu", params=init)
    jr, tr = jt.train(), tt.train()
    assert [s for s, _ in tr["history"]] == list(range(1, steps + 1))
    for (js, jl), (ts, tl) in zip(jr["history"], tr["history"]):
        assert js == ts
        assert abs(tl - jl) <= 1e-4 * abs(jl), (ts, tl, jl)
    assert tr["history"][-1][1] < tr["history"][0][1]
    bound = 2 * ttc.peak_lr * steps
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jt.params),
                            tree_leaves(tt.params)):
        err = np.abs(g.detach().numpy() - np.asarray(w)).max()
        assert err <= bound, (jax.tree_util.keystr(path), err, bound)
    assert int(tt.opt_state.step) == int(jt.opt_state.step) == steps


def test_restart_is_exact(tmp_path):
    """JAX's restart test on the port: train 6 steps; in another run train
    5 (past the step-4 checkpoint), resume a fresh trainer and finish; the
    final losses agree within 1e-5."""
    cfg = get_config("zamba2-1.2b", reduced=True)
    tc = lambda d: TrainConfig(arch=cfg, global_batch=4, seq_len=16, steps=6,
                               ckpt_dir=str(d), ckpt_every=4, log_every=1,
                               warmup_steps=2, seed=5)
    r1 = Trainer(tc(tmp_path / "a"), device="cpu").train()
    t2 = Trainer(tc(tmp_path / "b"), device="cpu")
    t2.train(steps=5)
    t3 = Trainer(tc(tmp_path / "b"), device="cpu")
    assert t3.maybe_resume() and t3.step == 4
    r3 = t3.train()
    assert abs(r1["final_loss"] - r3["final_loss"]) < 1e-5


def test_jax_checkpoint_restores_bit_for_bit(tmp_path):
    """A checkpoint the JAX trainer wrote (params and AdamW state after two
    steps) restores into the port's trainer bit for bit, keyed by the same
    paths; one the port writes restores into the JAX trainer the same."""
    jtc, ttc = _tcs("zamba2-1.2b", 2, ckpt_dir=str(tmp_path / "jax"),
                    ckpt_every=2)
    jt = JaxTrainer(jtc)
    jt.train()
    tt = Trainer(ttc, device="cpu")
    assert tt.maybe_resume() and tt.step == 2
    want = jax.tree_util.tree_map(
        np.asarray, {"params": jt.params, "opt_state": jt.opt_state})
    got = to_numpy(tt.state_tree())
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert len(wl) == len(tree_leaves(got))
    for (path, w), g in zip(wl, tree_leaves(got)):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))
    manifest = json.loads((tmp_path / "jax" / "step_00000002" /
                           "manifest.json").read_text())
    port_dir = tmp_path / "port"
    ckpt.save(str(port_dir), 2, tt.state_tree())
    port_manifest = json.loads((port_dir / "step_00000002" /
                                "manifest.json").read_text())
    assert port_manifest["tensors"] == manifest["tensors"]
    back, meta = jax_ckpt.restore(str(port_dir), 2, {
        "params": jt.params, "opt_state": jt.opt_state})
    assert meta["step"] == 2
    for (path, w), b in zip(wl, jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), w, err_msg=str(path))


def test_checkpoint_atomicity_and_async_saver(tmp_path):
    tree = {"w": torch.arange(10.0), "s": (torch.tensor(3, dtype=torch.int32),
                                          torch.ones(2).bfloat16())}
    ckpt.save(str(tmp_path), 3, tree)
    assert ckpt.latest_step(str(tmp_path)) == 3
    restored, meta = ckpt.restore(str(tmp_path), 3, tree)
    assert meta["step"] == 3
    for a, b in zip(tree_leaves(restored), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    saver = ckpt.AsyncSaver()
    saver.save_async(str(tmp_path), 7, {"w": torch.ones(10)},
                     extra_meta={"arch": "x"})
    saver.wait()
    assert ckpt.latest_step(str(tmp_path)) == 7
    assert ckpt.restore(str(tmp_path), 7, {"w": torch.zeros(10)}
                        )[1]["arch"] == "x"
    (tmp_path / ".tmp_save_stale").mkdir()
    ckpt.save(str(tmp_path), 8, {"w": torch.ones(10)})
    assert not (tmp_path / ".tmp_save_stale").exists()
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), 8, {"w": torch.zeros(3)})
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path), 8, {"v": torch.zeros(10)})
    assert ckpt.latest_step(str(tmp_path / "none")) is None


def test_prefill_sees_the_weights_after_a_step():
    """An optimizer step updates the parameters in place; the serving
    path's compute copy follows it, and the logits equal a model built
    from the new weights."""
    cfg = get_config("zamba2-1.2b", reduced=True)
    tc = TrainConfig(arch=cfg, global_batch=2, seq_len=16, steps=1,
                     warmup_steps=0, peak_lr=1e-2)
    t = Trainer(tc, device="cpu")
    prompt = torch.from_numpy(_batch(cfg, 2, 9)["tokens"])
    before, _ = t.model.prefill(prompt)
    t.train()
    after, _ = t.model.prefill(prompt)
    fresh, _ = model_class(cfg)(cfg, t.model.param_tree()).prefill(prompt)
    assert not torch.equal(before, after)
    assert torch.equal(after, fresh)


def test_train_then_serve_roundtrip(tmp_path):
    """Train a tiny model, checkpoint it, serve from the checkpoint."""
    cfg = get_config("tinyllama-1.1b", reduced=True)
    tc = TrainConfig(arch=cfg, global_batch=8, seq_len=32, steps=10,
                     ckpt_dir=str(tmp_path), ckpt_every=10, log_every=5,
                     warmup_steps=2)
    t = Trainer(tc, device="cpu")
    t.train()
    step = ckpt.latest_step(str(tmp_path))
    assert step == 10
    restored, _ = ckpt.restore(str(tmp_path), step, t.state_tree())
    model = lm_params_from_numpy(to_numpy(restored["params"]), cfg,
                                 device="cpu")
    eng = ServeEngine(model, ServeConfig(max_batch=2, max_len=48))
    eng.submit(Request(uid=0, prompt=np.asarray([1, 2, 3], np.int32),
                       max_new_tokens=5))
    done = eng.run_until_drained()
    assert len(done) == 1 and len(done[0].output) == 5


def test_compressed_pod_grad_mode_belongs_to_the_distributed_slice():
    """Without a mesh there is no pod hop to compress: "compressed" trains
    as "auto" does, bit for bit, as the JAX package's step does without a
    "pod" axis (the mesh trainer's compressed hop is held in
    tests/test_torch_parallel_train.py)."""
    cfg = get_config("zamba2-1.2b", reduced=True)
    runs = []
    for mode in ("auto", "compressed"):
        tc = TrainConfig(arch=cfg, global_batch=2, seq_len=16, steps=2,
                         warmup_steps=1, log_every=1, pod_grad_mode=mode)
        t = Trainer(tc, device="cpu")
        assert t.ef_state is None
        runs.append((t.train()["history"], tree_leaves(t.params)))
        assert callable(build_train_step(tc, t.model, t.opt))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def test_train_cli_ends_in_its_json_line(capsys):
    train_main(["--arch", "zamba2-1.2b", "--reduced", "--device", "cpu",
                "--steps", "3", "--batch", "2", "--seq", "16"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["arch"] == "zamba2-1.2b" and line["steps"] == 3
    assert np.isfinite(line["final_loss"]) and line["history"][-1][0] == 3

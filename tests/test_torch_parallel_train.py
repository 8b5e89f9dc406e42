"""The mesh ``Trainer`` (``repro_torch.train.zero``: rows per rank, the
funnel, FSDP-3 and ZeRO-sharded parameters and state, Megatron tensor
parallelism over "model", MoE over the global batch) against the JAX
package's trainer, on gloo CPU ranks.

Exact mode: ``python -m repro_torch.dist_check --cases train`` at 4 and
8 ranks runs reduced qwen1.5-0.5b (dense), zamba2-1.2b (hybrid) and
kimi-k2 (MoE, einsum dispatch, choices dropping) from the JAX trainer's
initial params (handed over with ``--keys``) for three steps on the (pod,
data, model) layouts (1, 4, 1), (2, 2, 1), (1, 2, 2), (1, 1, 4) and
(2, 2, 2), llama4-scout (the shuffle dispatch over "model", a shared
expert, capacity 8) on (1, 2, 2) and (2, 2, 2), and at 4 ranks reduced
rwkv6-1.6b, whisper-base and internvl2-2b on (1, 2, 2) and (1, 1, 4);
each is held to the JAX ``Trainer(mesh=None)``: every logged loss within
1e-5 relative, and the final params within 1e-5 in the relative L2 norm
of the whole tree and 1e-4 of each leaf.  (AdamW moves a parameter whose
gradient is rounding noise, such as qwen's key bias, which softmax
ignores, by a step that depends on the summation order: the port on one
device already differs from JAX by 4.5e-5 relative in that leaf.)
rwkv6 is held without the per-leaf rule, which the port on one device
misses too (``dist_check.GRAD_HELD``), and instead on its first step's
gradient, each leaf within 2e-4 of its largest element on one device.
Every rank ends with the same params, bit for bit (``--check``).

Compressed mode: on the two-pod layouts the error-feedback int8 hop is
held to the JAX compressed ``build_train_step`` run with a stand-in mesh
of ``pod = 2`` (it reads only the axis names and the pod size): losses
within 1e-3 relative, and the final loss within 5 % of exact mode (the
JAX package's own bound).  ZeRO and FSDP: each rank's AdamW moment bytes
and resident parameter bytes are the whole tree's over the shard count
each leaf's spec implies.  At model = 2 a rank's attention sees half the
heads and its MLP half the d_ff columns (a shape hook).  The MoE layers'
aux loss and dropped fraction on a mesh are the JAX ``_moe_einsum``'s on
the global batch.  Elastic:
``--cases elastic-train`` trains 3 steps on every rank, resumes on half
through ``plan_mesh`` and equals an uninterrupted run there (dist_check
holds it); the JAX ``ckpt.restore`` reads the checkpoint the port wrote to
the port's state, bit for bit.  The MoE (einsum and, in an expert group of
one gloo rank, shuffle), VLM and enc-dec reduced configs train as the JAX
``Trainer(mesh=None)`` does, step for step.  ``torchrun ...
repro_torch.launch.train --mesh host`` prints one JSON line.

Sequence parallelism (``--cases train-sp`` on the same 4-rank spawn): with
``seq_shard_activations`` every family trains on (1, 1, 4) and (1, 2, 2)
with the residual stream's sequence split over "model", held to the JAX
Trainer as above, to the same layout without the flag and, on rank 0, to
one device; kimi-k2's MoE aux and drops equal the run without the flag;
two planted faults miss one device; ``MeshServe``'s prefill with the
prompt split equals the JAX model; a two-microbatch SP step's counts on
gloo equal the per-rank dry run's.
"""
import json
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jax_get_config
from repro.data import make_pipeline as jax_make_pipeline
from repro.models import build_model as jax_build_model
from repro.optim import compress as jax_compress
from repro.optim import make_optimizer as jax_make_optimizer
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import Trainer as JaxTrainer
from repro.train import checkpoint as jax_ckpt
from repro.train.trainer import build_train_step as jax_build_train_step
from repro_torch import dist_check as DC
from repro_torch._tree import tree_leaves
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.sharding import use_expert_group
from repro_torch.train import Trainer, TrainConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS = DC.TRAIN_STEPS
LOSS_TOL_COMPRESSED = 1e-3
WORLDS = (4, 8)


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "JAX_PLATFORMS": "cpu"}


def _jax_tc(arch, **kw):
    """The JAX twin of ``dist_check.train_config``."""
    tc = DC.train_config(arch, **kw)
    over = {k: getattr(tc.arch, k) for k in ("optimizer", "moe_dispatch",
                                             "capacity_factor")}
    return JaxTrainConfig(
        arch=jax_get_config(arch, reduced=True, **over),
        global_batch=tc.global_batch, seq_len=tc.seq_len, steps=tc.steps,
        warmup_steps=tc.warmup_steps, log_every=tc.log_every, seed=tc.seed,
        pod_grad_mode=tc.pod_grad_mode, ckpt_dir=tc.ckpt_dir,
        ckpt_every=tc.ckpt_every)


def _losses(history):
    return np.array([l for _, l in history], np.float64)


def _jax_compressed(arch, init, n_pod):
    """The JAX compressed step with a stand-in mesh of ``n_pod`` pods."""
    jtc = _jax_tc(arch, pod_grad_mode="compressed")
    model, opt = jax_build_model(jtc.arch), jax_make_optimizer(jtc.arch)
    mesh = SimpleNamespace(axis_names=("pod", "data", "model"),
                           shape={"pod": n_pod, "data": 1, "model": 1})
    step = jax.jit(jax_build_train_step(jtc, model, opt, mesh))
    params = jax.tree_util.tree_map(jnp.asarray, init)
    opt_state, ef = opt.init(params), jax_compress.ef_init(params,
                                                           n_pod=n_pod)
    pipe = jax_make_pipeline(jtc.arch, jtc.global_batch, jtc.seq_len,
                             seed=jtc.seed)
    losses = []
    for s in range(jtc.steps):
        batch = {k: jnp.asarray(v) for k, v in pipe.batch_at(s).items()}
        params, opt_state, ef, loss = step(params, opt_state, ef, batch)
        losses.append(float(loss))
    return np.array(losses), params


#: the archs the JAX trainer runs as the oracle
JAX_ARCHS = DC.TRAIN_ARCHS + tuple(DC.MOE_TRAIN) + tuple(DC.FAMILY_TRAIN)


@pytest.fixture(scope="module")
def _started(tmp_path_factory):
    """The JAX trainers (initialised, not yet run) and the JAX init of
    ``dist_check.SERVE_CASES``, and the gloo ranks of every world started
    on them at once (``dist_check --keys``): the ranks run while this
    process computes the JAX oracle."""
    trainers = {arch: JaxTrainer(_jax_tc(arch)) for arch in JAX_ARCHS}
    inits = {arch: jax.tree_util.tree_map(np.array, jt.params)
             for arch, jt in trainers.items()}
    serve = {}
    for arch, _, _ in DC.SERVE_CASES:
        model = jax_build_model(jax_get_config(arch, reduced=True))
        serve[arch] = (model, model.init(jax.random.PRNGKey(11)))
    root = tmp_path_factory.mktemp("train_ranks")
    keys = {f"train/{arch}/{i}": leaf for arch, init in inits.items()
            for i, leaf in enumerate(jax.tree_util.tree_leaves(init))}
    keys.update({f"serve/{arch}/{i}": np.asarray(leaf)
                 for arch, (_, params) in serve.items()
                 for i, leaf in enumerate(jax.tree_util.tree_leaves(params))})
    np.savez(root / "keys.npz", **keys)
    procs = {}
    for world in WORLDS:
        cases = ("train,elastic-train,mesh-serve,mesh-count,train-sp"
                 if world == 4 else "train")
        procs[world] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.dist_check", "--world",
             str(world), "--out", str(root / f"w{world}"), "--cases", cases,
             "--keys", str(root / "keys.npz"), "--check", "--timeout",
             "240"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=_env())
    try:
        yield trainers, inits, serve, root, procs
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module")
def jax_runs(_started):
    """arch -> (init params, exact losses, exact final params, compressed
    losses at pod = 2)."""
    trainers, inits, *_ = _started
    out = {}
    for arch, jt in trainers.items():
        init = inits[arch]
        r = jt.train()
        final = [np.asarray(x) for x in jax.tree_util.tree_leaves(jt.params)]
        comp = _jax_compressed(arch, init, 2)[0] \
            if arch == DC.TRAIN_ARCHS[0] else None
        out[arch] = (init, _losses(r["history"]), final, comp)
    return out


@pytest.fixture(scope="module")
def jax_serve(_started):
    """arch -> (the one-device JAX prefill's last logits, the next decode
    step's logits) of ``dist_check.SERVE_CASES``, from the JAX init the
    ranks serve."""
    out = {}
    for arch, _, batch in DC.SERVE_CASES:
        model, params = _started[2][arch]
        logits, state = model.prefill(params, {
            "tokens": jnp.asarray(DC.serve_tokens(arch, batch)),
            "max_len": DC.SERVE_MAX_LEN})
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        step, _ = model.decode_step(params, tok, state)
        out[arch] = (np.asarray(logits), np.asarray(step))
    return out


@pytest.fixture(scope="module")
def ranks(_started, jax_runs, jax_serve):
    """world -> (out dir, each rank's results) of the training cases, from
    the JAX init (and at four ranks the sharded serving and counted
    cases), joined after the JAX oracle ran."""
    root, procs = _started[3:]
    out = {}
    for world, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=280)
        assert proc.returncode == 0, stdout + stderr[-6000:]
        d = root / f"w{world}"
        out[world] = (d, DC.load_ranks(d, world))
    return out


def _run(res, tag, variant):
    """(losses, param leaves) of one training variant in a rank's file."""
    n = sum(1 for k in res if k.startswith(f"{tag}/{variant}/"))
    return res[f"{tag}/{variant}/0"], [res[f"{tag}/{variant}/{i}"]
                                       for i in range(1, n)]


LAYOUTS = [(w, s) for w in WORLDS for s in DC.TRAIN_MESHES[w]]


def _tag(arch, shape):
    return f"train-{arch}-{'x'.join(map(str, shape))}"


@pytest.mark.parametrize("world,shape", LAYOUTS,
                         ids=["x".join(map(str, s)) for _, s in LAYOUTS])
@pytest.mark.parametrize("arch", DC.TRAIN_ARCHS)
def test_exact_mesh_trainer_matches_jax(arch, world, shape, ranks, jax_runs):
    _, want_losses, want_params, _ = jax_runs[arch]
    for r, res in enumerate(ranks[world][1]):
        losses, params = _run(res, _tag(arch, shape), "mesh")
        assert len(losses) == STEPS
        DC._held(losses, params, want_losses, want_params, DC.TRAIN_TOL,
                 f"{arch} {shape} rank {r}")


MOE_LAYOUTS = [(arch, w, s) for arch in DC.MOE_TRAIN for w in WORLDS
               for s in DC.train_layouts(arch, w)]


@pytest.mark.parametrize("arch,world,shape", MOE_LAYOUTS, ids=[
    f"{a}-{'x'.join(map(str, s))}" for a, _, s in MOE_LAYOUTS])
def test_moe_mesh_trainer_matches_jax(arch, world, shape, ranks, jax_runs):
    """kimi-k2 with choices dropping at capacity 1.25: the capacity groups
    span the ranks, so every position must be the global one."""
    _, want_losses, want_params, _ = jax_runs[arch]
    for r, res in enumerate(ranks[world][1]):
        losses, params = _run(res, _tag(arch, shape), "mesh")
        assert len(losses) == STEPS
        DC._held(losses, params, want_losses, want_params, DC.TRAIN_TOL,
                 f"{arch} {shape} rank {r}")


FAMILY_LAYOUTS = [(arch, w, s) for arch in DC.FAMILY_TRAIN for w in WORLDS
                  for s in DC.train_layouts(arch, w)]


@pytest.mark.parametrize("arch,world,shape", FAMILY_LAYOUTS, ids=[
    f"{a}-{'x'.join(map(str, s))}" for a, _, s in FAMILY_LAYOUTS])
def test_family_mesh_trainer_matches_jax(arch, world, shape, ranks,
                                         jax_runs):
    """rwkv6 (time mixing on the rank's heads at model = 2, on every head
    from the gathered matrices at model = 4), whisper's encoder-decoder
    and internvl2 (two KV heads, cut mid-head at model = 4) on every
    rank."""
    _, want_losses, want_params, _ = jax_runs[arch]
    by_grad = arch in DC.GRAD_HELD
    for r, res in enumerate(ranks[world][1]):
        losses, params = _run(res, _tag(arch, shape), "mesh")
        assert len(losses) == STEPS
        DC._held(losses, params, want_losses, want_params, DC.TRAIN_TOL,
                 f"{arch} {shape} rank {r}", per_leaf=not by_grad)
    if by_grad:
        err = ranks[world][1][0][f"{_tag(arch, shape)}/grad/#errors"]
        assert len(err) == len(want_params)
        assert err.max() <= DC.GRAD_TOL


@pytest.fixture(scope="module")
def jax_moe_stats(jax_runs):
    """arch -> the JAX ``_moe_einsum``'s (aux, dropped) of each MoE layer
    on the first step's global batch: the layers' inputs from the port's
    one-device model (equal to the JAX model's, tests/test_torch_moe.py),
    the layer run by the JAX package."""
    from repro.models import moe as jax_moe
    from repro_torch.models import moe as port_moe
    out = {}
    for arch in DC.MOE_TRAIN:
        init = jax_runs[arch][0]
        tc = DC.train_config(arch)
        t = Trainer(tc, device="cpu", params=init)
        inputs, real = [], port_moe.apply_moe

        def record(p, cfg, z):
            inputs.append(z.detach().numpy())
            return real(p, cfg, z)
        port_moe.apply_moe = record
        try:
            t.model.loss_fn({k: torch.from_numpy(v) for k, v in
                             t.pipeline.batch_at(0).items()})
        finally:
            port_moe.apply_moe = real
        jcfg = _jax_tc(arch).arch
        stats = []
        for i, z in enumerate(inputs[:jcfg.n_layers]):
            lp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[i]),
                                        init["layers"]["moe"])
            o = jax_moe._moe_einsum(lp, jcfg, jnp.asarray(z))
            stats.append((float(o.aux_loss), float(o.dropped_frac)))
        out[arch] = np.array(stats)
    return out


@pytest.mark.parametrize("world,shape", [(w, s) for w, s in LAYOUTS
                                         if s[0] == 2])
def test_compressed_pod_hop_matches_jax(world, shape, ranks, jax_runs):
    arch = DC.TRAIN_ARCHS[0]
    _, exact, _, want = jax_runs[arch]
    for res in ranks[world][1]:
        losses, _ = _run(res, _tag(arch, shape), "compressed")
        np.testing.assert_allclose(losses, want, rtol=LOSS_TOL_COMPRESSED,
                                   atol=0)
        assert abs(losses[-1] - exact[-1]) <= DC.COMPRESSED_TOL * exact[-1]
        assert not np.array_equal(losses, exact)     # it did quantize


@pytest.mark.parametrize("world,shape", LAYOUTS,
                         ids=["x".join(map(str, s)) for _, s in LAYOUTS])
def test_zero_moment_bytes_scale_with_the_shards(world, shape, ranks):
    for arch in DC.TRAIN_ARCHS:
        for res in ranks[world][1]:
            meta = {k: int(res[f"{_tag(arch, shape)}/per-rank/#{k}"])
                    for k in ("moment_bytes", "whole_bytes",
                              "implied_bytes")}
            assert meta["moment_bytes"] == meta["implied_bytes"]
            if np.prod(shape) > 1:
                assert meta["moment_bytes"] < meta["whole_bytes"]
            else:
                assert meta["moment_bytes"] == meta["whole_bytes"]


@pytest.mark.parametrize("world,shape", LAYOUTS,
                         ids=["x".join(map(str, s)) for _, s in LAYOUTS])
def test_resident_param_bytes_scale_with_the_shards(world, shape, ranks):
    """A rank holds its shard of each parameter and no whole copy."""
    archs = [a for a in DC.TRAIN_ARCHS + tuple(DC.MOE_TRAIN)
             + tuple(DC.FAMILY_TRAIN) if shape in DC.train_layouts(a, world)]
    for arch in archs:
        for res in ranks[world][1]:
            meta = {k: int(res[f"{_tag(arch, shape)}/per-rank/#{k}"])
                    for k in ("param_bytes", "param_whole_bytes",
                              "param_implied_bytes")}
            assert meta["param_bytes"] == meta["param_implied_bytes"]
            assert meta["param_bytes"] < meta["param_whole_bytes"]


def test_model_axis_splits_heads_and_d_ff(ranks):
    """At model = 2 every attention call of a rank sees n_heads / 2 query
    heads and every MLP gate activation d_ff / 2 columns."""
    arch = DC.TRAIN_ARCHS[0]
    cfg = get_config(arch, reduced=True)
    for res in ranks[4][1]:
        tag = f"{_tag(arch, DC.SHAPE_MESH)}/per-rank"
        assert list(res[f"{tag}/#heads"]) == [cfg.n_heads // 2]
        assert list(res[f"{tag}/#widths"]) == [cfg.d_ff // 2]
    # and whole on one rank of "model"
    res = ranks[4][1][0]
    assert list(res[f"{_tag(arch, (1, 4, 1))}/per-rank/#heads"]) == [
        cfg.n_heads]


@pytest.mark.parametrize("arch", list(DC.MOE_TRAIN))
def test_moe_aux_and_drops_are_the_global_batch_ones(arch, ranks,
                                                     jax_moe_stats):
    """Each MoE layer's aux loss and dropped fraction at the first step,
    on every layout and rank, equal the JAX layer's on the whole batch
    (and drops happen for kimi-k2, so the global positions decide)."""
    want = jax_moe_stats[arch]
    if arch == "kimi-k2-1t-a32b":
        assert want[:, 1].max() > 0
    for world in WORLDS:
        for shape in DC.train_layouts(arch, world):
            for res in ranks[world][1]:
                got = res[f"{_tag(arch, shape)}/moe/0"]
                np.testing.assert_allclose(got[:, 0], want[:, 0],
                                           rtol=1e-5, atol=0)
                np.testing.assert_allclose(got[:, 1], want[:, 1],
                                           rtol=0, atol=1e-6)


def test_adafactor_shards_train_as_one_device(ranks):
    """dist_check held it to the one-device run; every rank agrees."""
    for world in WORLDS:
        losses = [res["train-adafactor/mesh/0"] for res in ranks[world][1]]
        assert all(np.array_equal(l, losses[0]) for l in losses)
        assert np.all(np.isfinite(losses[0])) and len(losses[0]) == STEPS


def test_elastic_resume_and_the_jax_reader(ranks):
    d, got = ranks[4]
    r0 = got[0]
    assert tuple(r0["elastic-train/plan/#shape"]) == (1, 2)
    assert [bool(res["elastic-train/per-rank/#member"]) for res in got] == \
        [True, True, False, False]
    resumed, _ = _run(r0, "elastic-train", "resumed")
    want, _ = _run(r0, "elastic-train", "uninterrupted")
    np.testing.assert_allclose(resumed, want, rtol=DC.TRAIN_TOL, atol=0)
    # the 4-rank checkpoint, read by the JAX package
    jt = JaxTrainer(_jax_tc("tinyllama-1.1b", steps=6))
    restored, meta = jax_ckpt.restore(str(d / "elastic-train"), 3, {
        "params": jt.params, "opt_state": jt.opt_state})
    assert meta["step"] == 3
    leaves = jax.tree_util.tree_leaves(restored)
    n = sum(1 for k in r0 if k.startswith("elastic-train/step3/"))
    assert n == len(leaves)
    for i, leaf in enumerate(leaves):
        np.testing.assert_array_equal(np.asarray(leaf),
                                      r0[f"elastic-train/step3/{i}"])


# --------------------------------------------------------- one process
@pytest.fixture
def world1(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


FAMILIES = ["kimi-k2-1t-a32b", "llama4-scout-17b-a16e", "internvl2-2b",
            "whisper-base"]


def _family_pair(arch, steps=4, **over):
    common = dict(global_batch=4, seq_len=16, steps=steps, warmup_steps=2,
                  log_every=1, seed=5)
    return (JaxTrainConfig(arch=jax_get_config(arch, reduced=True, **over),
                           **common),
            TrainConfig(arch=get_config(arch, reduced=True, **over),
                        **common))


def _held_to_jax(jt, jr, tt, tr):
    DC._held(_losses(tr["history"]), tree_leaves(tt.params),
             _losses(jr["history"]),
             [np.asarray(x) for x in jax.tree_util.tree_leaves(jt.params)],
             DC.TRAIN_TOL, "family")


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_trainer_matches_the_jax_trainer(arch, ranks, jax_runs):
    """The port's one-device Trainer against the JAX Trainer from the JAX
    init.  kimi-k2, internvl2 and whisper: the train case's run without a
    mesh (rank 0 of the 4-rank spawn) against the JAX oracle's;
    llama4-scout, which the train case runs with the shuffle dispatch at
    capacity 8, at its own config."""
    if DC.train_layouts(arch, 4) and not DC._listed(arch)[0]:
        losses, params = _run(ranks[4][1][0], f"train-{arch}", "single")
        _, want_losses, want_params, _ = jax_runs[arch]
        DC._held(losses, params, want_losses, want_params, DC.TRAIN_TOL,
                 arch, per_leaf=arch not in DC.GRAD_HELD)
        return
    jtc, ttc = _family_pair(arch)
    jt = JaxTrainer(jtc)
    init = jax.tree_util.tree_map(np.array, jt.params)
    tt = Trainer(ttc, device="cpu", params=init)
    _held_to_jax(jt, jt.train(), tt, tt.train())


def test_moe_shuffle_dispatch_trains_as_the_jax_trainer(world1):
    """In an expert group of one rank, at a capacity where nothing drops,
    the shuffle dispatch trains as the JAX trainer (whose dispatch without
    a mesh is the einsum one)."""
    over = dict(moe_dispatch="shuffle", capacity_factor=8.0)
    jtc, ttc = _family_pair("kimi-k2-1t-a32b", **over)
    jt = JaxTrainer(jtc)
    init = jax.tree_util.tree_map(np.array, jt.params)
    tt = Trainer(ttc, device="cpu", params=init)
    with use_expert_group(dist.group.WORLD):
        tr = tt.train()
    _held_to_jax(jt, jt.train(), tt, tr)


@pytest.mark.parametrize("mode", ["auto", "compressed"])
def test_one_rank_mesh_trainer(mode, world1, jax_runs):
    """On a (1, 1, 1) mesh: "auto" is the one-device step bit for bit;
    "compressed" quantizes the one pod's gradient as the JAX compressed
    step with one pod does."""
    arch = DC.TRAIN_ARCHS[0]
    init = jax_runs[arch][0]
    tc = DC.train_config(arch, pod_grad_mode=mode)
    mesh = make_host_mesh((1, 1, 1), ("pod", "data", "model"))
    got = Trainer(tc, device="cpu", params=init, mesh=mesh)
    gr = got.train()
    if mode == "auto":
        plain = Trainer(DC.train_config(arch), device="cpu", params=init)
        assert gr["history"] == plain.train()["history"]
        for a, b in zip(tree_leaves(got.params), tree_leaves(plain.params)):
            assert torch.equal(a, b)
    else:
        want, _ = _jax_compressed(arch, init, 1)
        np.testing.assert_allclose(_losses(gr["history"]), want,
                                   rtol=LOSS_TOL_COMPRESSED, atol=0)
        assert got.ef_state is not None


def test_moe_trains_over_a_model_axis(ranks):
    """A MoE config trains over a "model" axis (its experts and heads
    split), every rank on the one-device losses."""
    for arch in DC.MOE_TRAIN:
        for world in WORLDS:
            for shape in DC.train_layouts(arch, world):
                if shape[2] == 1:
                    continue
                for res in ranks[world][1]:
                    losses, _ = _run(res, _tag(arch, shape), "mesh")
                    single, _ = _run(ranks[world][1][0],
                                     f"train-{arch}", "single")
                    np.testing.assert_allclose(losses, single,
                                               rtol=DC.TRAIN_TOL, atol=0)


@pytest.mark.parametrize("shape", [(1, 4, 1), (2, 2, 1), (2, 2, 2)])
def test_moe_trains_over_pod_or_data_ranks(shape, ranks):
    """Over pod x data ranks a MoE layer routes with the router statistics
    and capacity groups of the global batch, so its aux loss and drops are
    the one-device run's, not each rank's own."""
    arch = "kimi-k2-1t-a32b"
    world = int(np.prod(shape))
    single = ranks[world][1][0][f"train-{arch}/moe/0"]
    for res in ranks[world][1]:
        got = res[f"{_tag(arch, shape)}/moe/0"]
        np.testing.assert_allclose(got[:, 0], single[:, 0], rtol=1e-5,
                                   atol=0)
        np.testing.assert_allclose(got[:, 1], single[:, 1], rtol=0,
                                   atol=1e-6)


def test_batch_that_does_not_split_over_the_ranks_raises(world1):
    from repro_torch.train.zero import MeshStep
    t = Trainer(DC.train_config(DC.TRAIN_ARCHS[0]), device="cpu",
                mesh=make_host_mesh())
    step = t._mesh_step
    assert isinstance(step, MeshStep)
    step.n_data = 3                      # as if three data ranks
    with pytest.raises(ValueError, match="does not split"):
        step.local_rows({"tokens": np.zeros((8, 4), np.int32)})


def test_launcher_trains_on_a_host_mesh_under_torchrun(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "-m", "repro_torch.launch.train", "--arch", "qwen1.5-0.5b",
         "--reduced", "--device", "cpu", "--mesh", "host", "--steps", "3",
         "--batch", "4", "--seq", "16", "--ckpt-dir", str(tmp_path),
         "--ckpt-every", "3"],
        capture_output=True, text=True, timeout=240, cwd=tmp_path,
        env={**_env(), "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [l for l in proc.stdout.splitlines() if l.startswith("{")]
    assert len(lines) == 1                     # rank 0 only
    line = json.loads(lines[0])
    assert line["arch"] == "qwen1.5-0.5b" and line["steps"] == 3
    assert np.isfinite(line["final_loss"])
    assert (tmp_path / "step_00000003" / "manifest.json").exists()


#: the port's serving tests' tolerance (tests/test_torch_lm.py, float32)
SERVE_TOL = 2e-4


@pytest.mark.parametrize("arch,shape,batch", DC.SERVE_CASES)
def test_sharded_prefill_and_decode_match_jax(arch, shape, batch, ranks,
                                              jax_serve):
    """Each of the decode state's three mesh layouts (KV heads over
    "model"; the head dimension over "model", tinyllama's one KV head;
    the sequence over "data" at B = 1): every rank's rows of the sharded
    prefill's last logits, its tokens, and the next decode step's logits
    equal the one-device JAX model's within 2e-4 (rtol and atol)."""
    want_prefill, want_step = jax_serve[arch]
    tag = f"serve-{arch}-{'x'.join(map(str, shape))}"
    n_rows = batch // (shape[1] if batch % shape[1] == 0 else 1)
    for r, res in enumerate(ranks[4][1]):
        i = (r // shape[2]) % shape[1] if n_rows < batch else 0
        rows = slice(i * n_rows, (i + 1) * n_rows)
        logits, step = res[f"{tag}/per-rank/0"], res[f"{tag}/per-rank/1"]
        np.testing.assert_allclose(logits, want_prefill[rows],
                                   rtol=SERVE_TOL, atol=SERVE_TOL)
        np.testing.assert_array_equal(np.argmax(logits, -1),
                                      np.argmax(want_prefill[rows], -1))
        np.testing.assert_allclose(step, want_step[rows], rtol=SERVE_TOL,
                                   atol=SERVE_TOL)


@pytest.mark.parametrize("case", DC.COUNT_CASES, ids=lambda c: c[2][0])
def test_rank_counts_equal_the_per_rank_dry_run(case, ranks):
    """The dry run's counter over each rank's real step on gloo (a
    training step of two microbatches, a prefill, a decode step) equals
    the per-rank dry run of that rank of the same layout on meta: FLOPs,
    bytes, kernel calls and collective bytes and counts by op."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    arch, over, shape, mesh = case
    cfg = get_config(arch, reduced=True, **over)
    tag = f"count-{arch}-{shape[0]}"
    for r, res in enumerate(ranks[4][1]):
        got = json.loads(str(res[f"{tag}/per-rank/#record"]))
        want = dryrun.mesh_dry_run(cfg, ShapeConfig(*shape), mesh, rank=r)
        for key in ("cost", "kernels", "collectives"):
            assert got[key] == want[key], (r, key)
        assert want["collectives"]["raw_total"] > 0


# ------------------------------------------- Megatron sequence parallelism
SP_LAYOUTS = [(a, s) for a in DC.SP_ARCHS for s in DC.SP_MESHES]


def _sp_tag(arch, shape):
    return f"train-sp-{arch}-{'x'.join(map(str, shape))}"


@pytest.mark.parametrize("arch,shape", SP_LAYOUTS, ids=[
    f"{a}-{'x'.join(map(str, s))}" for a, s in SP_LAYOUTS])
def test_sequence_parallel_trainer_matches_jax(arch, shape, ranks,
                                               jax_runs):
    """With ``seq_shard_activations`` the residual stream's sequence is
    split over "model" (at (1, 1, 4) and (1, 2, 2) the 16 positions a row
    into 4 or 2 slices): every rank's losses and final params equal the
    one-device JAX Trainer's (whose flag without a mesh changes nothing,
    ``test_jax_seq_shard_flag_needs_a_mesh``) within 1e-5, rwkv6 without
    the per-leaf rule; dist_check held each run to the same layout
    without the flag and, on rank 0, to one device (losses, the whole
    tree, each leaf's first-step gradient within 2e-4 of its max)."""
    _, want_losses, want_params, _ = jax_runs[arch]
    for r, res in enumerate(ranks[4][1]):
        losses, params = _run(res, _sp_tag(arch, shape), "mesh")
        assert len(losses) == STEPS
        DC._held(losses, params, want_losses, want_params, DC.TRAIN_TOL,
                 f"{arch} {shape} sp rank {r}",
                 per_leaf=arch not in DC.GRAD_HELD)
        plain = res[f"{_sp_tag(arch, shape)}/plain/0"]
        np.testing.assert_allclose(losses, plain, rtol=DC.TRAIN_TOL, atol=0)


def test_sequence_parallel_moe_aux_and_drops(ranks):
    """kimi-k2 routes on each rank's slice and gathers the routes: each
    MoE layer's first-step aux loss and dropped fraction equal the run
    without the flag (the global batch's: the capacity groups span the
    slices and the batch ranks), which drops choices; dist_check held
    llama4-scout's shuffle dispatch so too."""
    arch = "kimi-k2-1t-a32b"
    for shape in DC.SP_MESHES:
        for res in ranks[4][1]:
            got = res[f"{_sp_tag(arch, shape)}/moe/0"]
            want = res[f"{_tag(arch, shape)}/moe/0"]
            np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-5,
                                       atol=0)
            np.testing.assert_array_equal(got[:, 1], want[:, 1])
    assert want[:, 1].max() > 0


@pytest.mark.parametrize("mutant", list(DC.SP_MUTANTS))
def test_sequence_parallel_mutants_fail_the_hold(mutant, ranks):
    """The planted faults (``dist_check.SP_MUTANTS``): without the "model"
    sum of the gradients of the leaves used on the slice (qwen's norm
    scales and biases), or with RWKV's channel mix shifting the rank's
    slice (which misses the previous rank's last position) rather than
    the gathered sequence, the run is not held to one device."""
    res = ranks[4][1][0]
    assert not bool(res[f"train-sp-mutant-{mutant}/per-rank/#held"])


@pytest.mark.parametrize("arch,shape,batch", DC.SP_SERVE_CASES)
def test_sequence_parallel_prefill_matches_jax(arch, shape, batch, ranks,
                                               jax_serve):
    """``MeshServe`` prefill with the prompt's 8 positions split over the
    4 "model" ranks (the decode step's one position stays whole): every
    rank's logits and tokens, and the next decode step's logits, equal
    the one-device JAX model's within 2e-4."""
    want_prefill, want_step = jax_serve[arch]
    tag = f"serve-sp-{arch}-{'x'.join(map(str, shape))}"
    for res in ranks[4][1]:
        logits, step = res[f"{tag}/per-rank/0"], res[f"{tag}/per-rank/1"]
        np.testing.assert_allclose(logits, want_prefill, rtol=SERVE_TOL,
                                   atol=SERVE_TOL)
        np.testing.assert_array_equal(np.argmax(logits, -1),
                                      np.argmax(want_prefill, -1))
        np.testing.assert_allclose(step, want_step, rtol=SERVE_TOL,
                                   atol=SERVE_TOL)


def test_jax_seq_shard_flag_needs_a_mesh():
    """The JAX package's ``residual_shard``, through which every layer
    the flag touches returns, is a sharding constraint: without a mesh
    it hands back its input with the flag set, so the one-device JAX
    Trainer the sequence-parallel runs are held to is the one the plain
    mesh runs are held to."""
    from repro.models.layers import residual_shard
    cfg = jax_get_config("qwen1.5-0.5b", reduced=True,
                         seq_shard_activations=True)
    x = jnp.arange(2 * 16 * cfg.d_model, dtype=jnp.float32).reshape(
        2, 16, cfg.d_model)
    assert residual_shard(cfg, x) is x

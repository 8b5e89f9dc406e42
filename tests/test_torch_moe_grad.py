"""Gradients through the MoE layer's ``shuffle`` dispatch against
``jax.grad`` of the JAX package's ``_moe_shuffle``.

The collectives of ``repro_torch.core.distributed`` carry a gradient
(``all_to_all``'s backward is the same all-to-all of the gradient), so the
dispatch trains its experts.  The objective is ``y.sum()`` on
``dist_check.moe_inputs()`` at capacity factor 8, where nothing drops.
The JAX oracle runs on Auto-axis (1, k) meshes, where every shard holds
every token: k = 1 in this process, k = 2 and 4 in one subprocess with 4
host devices.  The port runs one gloo rank in this process and 2 and 4
ranks through ``python -m repro_torch.dist_check --cases moe-grad``, every
rank on every token.  Each rank's y, router and x gradients are held to
the JAX ones; each rank's expert slice is fed by every rank's copy of the
tokens, so the group's SUM of the expert gradients over k is.  With the
parent commit's all-to-all (a fresh buffer, no ``grad_fn``) the experts
get no gradient and the check fails.  Tolerance 2e-4 (rtol and atol),
float32.
"""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AxisType

from repro.configs import get_config as jax_get_config
from repro.models import moe as jm
from repro.models import sharding as jsh
from repro_torch import dist_check as DC
from repro_torch.configs import get_config
from repro_torch.core import distributed as D
from repro_torch.interop import tree_from_numpy
from repro_torch.models import moe as tm
from repro_torch.models.sharding import use_expert_group

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 2e-4
CF = DC.MOE_CFS[-1]
NAMES = ("router", "w_down", "w_gate", "w_up")

JAX_ORACLE = """
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_config
from repro.models import moe as jm, sharding as shm
from repro_torch import dist_check as DC
params, x = DC.moe_inputs()
params = jax.tree_util.tree_map(jnp.asarray, params)
cfg = get_config(DC.MOE_ARCH, reduced=True, capacity_factor=DC.MOE_CFS[-1],
                 **DC.MOE_OVERRIDES)
out = {}
for k in (2, 4):
    mesh = jax.make_mesh((1, k), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    with shm.use_mesh(mesh):
        f = jax.jit(jax.value_and_grad(
            lambda p, x: jm._moe_shuffle(p, cfg, x).y.sum(), argnums=(0, 1)))
        _, (gp, gx) = f(params, jnp.asarray(x))
    for n, v in gp.items():
        out[f"{k}/{n}"] = np.asarray(v)
    out[f"{k}/x"] = np.asarray(gx)
np.savez(sys.argv[1], **out)
"""


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL, err_msg=what)


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "JAX_PLATFORMS": "cpu"}


def _jax_cfg():
    return jax_get_config(DC.MOE_ARCH, reduced=True, capacity_factor=CF,
                          **DC.MOE_OVERRIDES)


@pytest.fixture(scope="module")
def _started(tmp_path_factory):
    """The JAX oracle's subprocess and the gloo ranks of both worlds
    (``dist_check --cases moe-grad``), started at once."""
    root = tmp_path_factory.mktemp("moe_grad_ranks")
    oracle = tmp_path_factory.mktemp("jax_moe_grad") / "oracle.npz"
    procs = {"jax": subprocess.Popen(
        [sys.executable, "-c", JAX_ORACLE, str(oracle)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**_env(),
             "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})}
    for world in (2, 4):
        procs[world] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.dist_check", "--world",
             str(world), "--out", str(root / f"w{world}"), "--cases",
             "moe-grad", "--check", "--timeout", "150"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env())
    try:
        yield root, oracle, procs
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def _joined(proc, timeout):
    stdout, stderr = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, stdout + stderr[-6000:]


@pytest.fixture(scope="module")
def jax_oracle(_started):
    """'{k}/{param | x}' gradients of the JAX dispatch on a (1, k) mesh."""
    _, oracle, procs = _started
    _joined(procs["jax"], 300)
    return dict(np.load(oracle))


@pytest.fixture(scope="module")
def ranks(_started):
    """world -> each rank's results of ``dist_check --cases moe-grad``."""
    root, _, procs = _started
    out = {}
    for world in (2, 4):
        _joined(procs[world], 180)
        out[world] = DC.load_ranks(root / f"w{world}", world)
    return out


@pytest.fixture
def world1(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_one():
    """(y, {param: grad}, x's grad) of the JAX dispatch on a (1, 1) mesh."""
    params, x = DC.moe_inputs()
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    cfg = _jax_cfg()
    with jsh.use_mesh(mesh):
        y = jax.jit(lambda p, x: jm._moe_shuffle(p, cfg, x).y)
        g = jax.jit(jax.grad(lambda p, x: jm._moe_shuffle(p, cfg, x).y.sum(),
                             argnums=(0, 1)))
        p, xj = jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x)
        gp, gx = g(p, xj)
        return np.asarray(y(p, xj)), {n: np.asarray(v) for n, v in
                                      gp.items()}, np.asarray(gx)


def _port_grads_one_rank():
    params, x = DC.moe_inputs()
    cfg = get_config(DC.MOE_ARCH, reduced=True, capacity_factor=CF,
                     **DC.MOE_OVERRIDES)
    with use_expert_group(dist.group.WORLD):
        return DC.moe_grads(tree_from_numpy(params), cfg,
                            torch.from_numpy(x), tm._moe_shuffle)


def _check(got, want):
    y, grads, gx = got
    wy, wgrads, wgx = want
    _close(y, wy, "y")
    _close(gx, wgx, "x")
    for n in NAMES:
        _close(grads[n], wgrads[n], n)


def test_one_rank_gradients_match_jax(world1, jax_one):
    _check(_port_grads_one_rank(), jax_one)


def test_the_parent_detached_all_to_all_fails_the_check(world1, monkeypatch,
                                                        jax_one):
    """The all-to-all as it was before: a fresh buffer without a grad_fn.
    The experts' weights then get no gradient and x only the router's."""
    monkeypatch.setattr(tm, "all_to_all",
                        lambda send, group=None: D._all_to_all(send.detach(),
                                                               group))
    got = _port_grads_one_rank()
    assert all(float(got[1][n].abs().max()) == 0.0
               for n in ("w_down", "w_gate", "w_up"))
    with pytest.raises(AssertionError):
        _check(got, jax_one)


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_gradients_match_jax_on_a_1xk_mesh(world, ranks, jax_oracle,
                                                jax_one):
    want = {n: jax_oracle[f"{world}/{n}"] for n in NAMES + ("x",)}
    jy = jax_one[0]
    for r, res in enumerate(ranks[world]):
        # (y, grads in sorted-name order, x's gradient)
        _close(res["moe-grad/per-rank/0"], jy, f"y of {r}")
        _close(res["moe-grad/per-rank/1"], want["router"], f"router {r}")
        _close(res["moe-grad/per-rank/5"], want["x"], f"x of {r}")
        for j, n in enumerate(("w_down", "w_gate", "w_up")):
            _close(res[f"moe-grad/group/{j}"], want[n], f"{n} group {r}")


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_computes_only_its_experts_gradient(world, ranks):
    e = get_config(DC.MOE_ARCH, reduced=True).n_experts
    for r, res in enumerate(ranks[world]):
        g = res["moe-grad/per-rank/3"]                       # w_gate
        mine = np.zeros(e, bool)
        mine[r * e // world:(r + 1) * e // world] = True
        assert np.abs(g[~mine]).max() == 0.0
        assert np.abs(g[mine]).max() > 0.0


def test_collectives_carry_gradients_only_where_asked(world1):
    x = torch.arange(6.0).reshape(3, 2).requires_grad_()
    for fn in (D.all_to_all, D.all_gather, D.all_reduce):
        y = fn(x)
        assert y.grad_fn is not None
        (y * 2).sum().backward()
        assert torch.equal(x.grad, torch.full_like(x, 2.0))
        x.grad = None
        assert fn(x.detach()).grad_fn is None
        with torch.no_grad():
            assert fn(x).grad_fn is None
    m = D.all_reduce(x, op=dist.ReduceOp.MAX)
    assert m.grad_fn is None and torch.equal(m, x.detach())
    flags = torch.tensor([True, False])
    assert torch.equal(D.all_to_all(flags), flags)


def test_remat_recomputes_in_the_forwards_expert_group(world1):
    """On the card autograd runs the backward on its device thread, where
    the expert group (a context variable) is unset; the layer's recompute
    must still take the shuffle dispatch.  Here the backward runs on a
    thread of its own, and its gradients equal the same thread's."""
    import threading

    from repro_torch.data import make_pipeline
    from repro_torch.models import build_model
    cfg = get_config(DC.MOE_ARCH, reduced=True, capacity_factor=CF,
                     moe_dispatch="shuffle", remat="full")
    batch = {k: torch.from_numpy(v) for k, v in
             make_pipeline(cfg, 2, 16, seed=0).batch_at(0).items()}
    grads = []
    for threaded in (False, True):
        model = build_model(cfg, device="cpu", seed=0)
        with use_expert_group(dist.group.WORLD):
            loss, _ = model.loss_fn(batch)
        errors = []

        def backward():
            try:
                loss.backward()
            except Exception as e:              # noqa: BLE001 - reported
                errors.append(e)
        if threaded:
            t = threading.Thread(target=backward)
            t.start()
            t.join()
        else:
            with use_expert_group(dist.group.WORLD):
                backward()
        assert not errors, errors
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for n, g in grads[0].items():
        assert torch.equal(g, grads[1][n]), n
    assert float(grads[1]["layers.moe.w_gate"].abs().max()) > 0

"""The MoE layer's ``shuffle`` dispatch (``repro_torch.models.moe.
_moe_shuffle`` over an expert group of gloo CPU ranks) against the JAX
package's ``_moe_shuffle`` on a (1, k) mesh.

The JAX oracle builds its mesh with ``AxisType.Auto`` axes: jax 0.9.0's
``make_mesh`` makes ``Explicit`` ones by default, on which the JAX
package's sharding constraints fail.  One rank runs in this process
against a (1, 1) mesh; 2 and 4 ranks run through ``python -m
repro_torch.dist_check --cases moe`` once each, and the JAX side of those
in one subprocess with 4 host devices (this process has one), all on
``dist_check.moe_inputs()``.  On a (1, k) mesh every shard holds every
token; where choices drop, each receiver admits its senders' copies in
rank order, so the shards' outputs differ, and the JAX result is shard
0's: rank 0's output is held to it, every rank's ``dropped_frac`` and
``aux`` to the JAX ones, and every rank's output where nothing drops.
Tolerance 2e-4 (rtol and atol) in float32; ``dropped_frac`` exactly.
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
from repro_torch.interop import tree_from_numpy
from repro_torch.models import moe as tm
from repro_torch.models.sharding import expert_group, use_expert_group

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 2e-4

JAX_ORACLE = """
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_config
from repro.models import moe as jm, sharding as shm
from repro_torch import dist_check as DC
params, x = DC.moe_inputs()
params = jax.tree_util.tree_map(jnp.asarray, params)
out = {}
for k in (2, 4):
    mesh = jax.make_mesh((1, k), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    for cf in DC.MOE_CFS:
        cfg = get_config(DC.MOE_ARCH, reduced=True, capacity_factor=cf,
                         **DC.MOE_OVERRIDES)
        with shm.use_mesh(mesh):
            o = jax.jit(lambda p, x: jm._moe_shuffle(p, cfg, x))(
                params, jnp.asarray(x))
        for name, v in zip(o._fields, o):
            out[f"{k}/{cf}/{name}"] = np.asarray(v)
np.savez(sys.argv[1], **out)
"""


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL, err_msg=what)


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "JAX_PLATFORMS": "cpu"}


@pytest.fixture(scope="module")
def _started(tmp_path_factory):
    """The JAX oracle's subprocess and the gloo ranks of both worlds
    (``dist_check --cases moe``), started at once."""
    root = tmp_path_factory.mktemp("moe_ranks")
    oracle = tmp_path_factory.mktemp("jax_moe") / "oracle.npz"
    procs = {"jax": subprocess.Popen(
        [sys.executable, "-c", JAX_ORACLE, str(oracle)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**_env(),
             "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})}
    for world in (2, 4):
        procs[world] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.dist_check", "--world",
             str(world), "--out", str(root / f"w{world}"), "--cases",
             "moe", "--check", "--timeout", "150"],
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
    """'{k}/{cf}/{y|aux_loss|dropped_frac}' of the JAX dispatch at k
    expert shards, run once in a subprocess with 4 host devices."""
    _, oracle, procs = _started
    _joined(procs["jax"], 300)
    return dict(np.load(oracle))


@pytest.fixture(scope="module")
def ranks(_started):
    """world -> each rank's results of ``dist_check --cases moe``, each
    world run once."""
    root, _, procs = _started
    out = {}
    for world in (2, 4):
        _joined(procs[world], 180)
        out[world] = DC.load_ranks(root / f"w{world}", world)
    return out


@pytest.fixture
def world1(tmp_path):
    """A gloo group of one rank in this process, destroyed afterwards."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("cf", DC.MOE_CFS)
def test_one_rank_matches_jax_on_a_1x1_mesh(cf, shared, world1):
    kw = dict(DC.MOE_OVERRIDES, capacity_factor=cf, shared_expert=shared)
    jcfg = jax_get_config(DC.MOE_ARCH, reduced=True, **kw)
    tcfg = get_config(DC.MOE_ARCH, reduced=True, **kw)
    params, x = DC.moe_inputs()
    if shared:
        rng = np.random.default_rng(301)
        d, f = tcfg.d_model, tcfg.moe_d_ff
        params["shared"] = {
            n: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
            for n, s in (("w_gate", (d, f)), ("w_up", (d, f)),
                         ("w_down", (f, d)))}
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    with jsh.use_mesh(mesh):
        want = jax.jit(lambda p, x: jm._moe_shuffle(p, jcfg, x))(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    with use_expert_group(dist.group.WORLD):
        assert expert_group() is dist.group.WORLD
        got = tm._moe_shuffle(tree_from_numpy(params), tcfg,
                              torch.from_numpy(x))
    assert expert_group() is None
    _close(got.y, want.y, "y")
    _close(got.aux_loss, want.aux_loss, "aux")
    assert got.dropped_frac.item() == float(want.dropped_frac)
    if cf == 1.0:
        assert got.dropped_frac.item() > 0


@pytest.mark.parametrize("cf", DC.MOE_CFS)
@pytest.mark.parametrize("world", [2, 4])
def test_ranks_match_jax_on_a_1xk_mesh(world, cf, ranks, jax_oracle):
    got = ranks[world]
    want = {n: jax_oracle[f"{world}/{cf}/{n}"]
            for n in ("y", "aux_loss", "dropped_frac")}
    _close(got[0][f"moe-{cf}/per-rank/0"], want["y"], "rank 0's y")
    for r, res in enumerate(got):
        _close(res[f"moe-{cf}/shuffle/0"], want["aux_loss"], f"aux {r}")
        assert float(res[f"moe-{cf}/shuffle/1"]) == \
            float(want["dropped_frac"]), r
        if cf == 8.0:                      # nothing drops: every rank's y
            _close(res[f"moe-{cf}/per-rank/0"], want["y"], f"y of {r}")
    assert (float(want["dropped_frac"]) > 0) == (cf == 1.0)


@pytest.mark.parametrize("world", [2, 4])
def test_shuffle_equals_einsum_where_nothing_drops(world, ranks):
    """At capacity factor 8 the two dispatches compute the same sum; at 1.0
    they size capacity differently (per shard against per group of
    tokens) and drop differently."""
    r0 = ranks[world][0]
    _close(r0["moe-8.0/per-rank/0"], r0["moe-8.0/einsum/0"], "y")
    assert float(r0["moe-8.0/einsum/2"]) == 0.0


def test_without_a_group_the_shuffle_is_the_einsum_dispatch():
    cfg = get_config(DC.MOE_ARCH, reduced=True, **DC.MOE_OVERRIDES)
    params, x = DC.moe_inputs()
    p, xt = tree_from_numpy(params), torch.from_numpy(x)
    assert expert_group() is None
    got, want = tm._moe_shuffle(p, cfg, xt), tm._moe_einsum(p, cfg, xt)
    for a, b in zip(got, want):
        assert torch.equal(a, b)

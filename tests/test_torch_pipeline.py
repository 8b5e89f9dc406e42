"""The GPipe schedule (``repro_torch.train.pipeline.run_pipeline``) against
the JAX package's ``run_pipeline``.

The oracle is the JAX ``run_pipeline`` itself: on one device in this
process, and on Auto-axis ``("pod",)`` meshes of 2 and 4 host devices in
one subprocess (jax 0.9.0's default ``Explicit`` axes make its
``shard_map`` refuse; ``tests/test_distributed.py`` builds them so and is
red for it).  Inputs are ``tests/test_distributed.py``'s: stages
``tanh(x @ w_s)``, 6 microbatches of (8, 16), from numpy seed 0.  The port
runs one stage a gloo rank (``dist_check --cases pipeline``, which also
holds every rank to the sequential chain) and in this process on a group
of one.  Forward within 2e-5, the gradients of ``sum(out ** 2)`` within
1e-5 (rtol and atol), float32; each stage's weights get their gradient on
their own rank only.
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

from repro.train.pipeline import run_pipeline as jax_run_pipeline
from repro_torch import dist_check as DC
from repro_torch.train.pipeline import ring_permute, run_pipeline

ROOT = pathlib.Path(__file__).resolve().parents[1]
FWD, GRAD = DC.PIPE_FWD_TOL, DC.PIPE_GRAD_TOL

JAX_ORACLE = """
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.train.pipeline import run_pipeline
from repro_torch import dist_check as DC
out = {}
f = lambda w, x: jnp.tanh(x @ w)
for n in (2, 4):
    ws, xs = map(jnp.asarray, DC.pipeline_inputs(n))
    mesh = jax.make_mesh((n,), ("pod",), axis_types=(AxisType.Auto,),
                         devices=jax.devices()[:n])
    run = lambda w, x: run_pipeline(f, w, x, mesh, axis_name="pod")
    out[f"{n}/out"] = np.asarray(run(ws, xs))
    gw, gx = jax.grad(lambda w, x: jnp.sum(run(w, x) ** 2),
                      argnums=(0, 1))(ws, xs)
    out[f"{n}/gw"], out[f"{n}/gx"] = np.asarray(gw), np.asarray(gx)
np.savez(sys.argv[1], **out)
"""


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "JAX_PLATFORMS": "cpu"}


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.fixture(scope="module")
def _started(tmp_path_factory):
    """The JAX oracle's subprocess and the gloo ranks of both worlds
    (``dist_check --cases pipeline``), started at once."""
    root = tmp_path_factory.mktemp("pipe_ranks")
    oracle = tmp_path_factory.mktemp("jax_pipe") / "oracle.npz"
    procs = {"jax": subprocess.Popen(
        [sys.executable, "-c", JAX_ORACLE, str(oracle)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**_env(),
             "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})}
    for world in (2, 4):
        procs[world] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.dist_check", "--world",
             str(world), "--out", str(root / f"w{world}"), "--cases",
             "pipeline", "--check", "--timeout", "120"],
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
    """The JAX ``run_pipeline`` oracle, run once in a subprocess with 4
    host devices."""
    _, oracle, procs = _started
    _joined(procs["jax"], 300)
    return dict(np.load(oracle))


@pytest.fixture(scope="module")
def ranks(_started):
    """world -> each rank's results of ``dist_check --cases pipeline``."""
    root, _, procs = _started
    out = {}
    for world in (2, 4):
        _joined(procs[world], 150)
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


def test_one_stage_matches_jax_on_one_device(world1):
    ws_np, xs_np = DC.pipeline_inputs(1)
    f = lambda w, x: jnp.tanh(x @ w)
    mesh = jax.make_mesh((1,), ("pod",), axis_types=(AxisType.Auto,))
    run = lambda w, x: jax_run_pipeline(f, w, x, mesh, axis_name="pod")
    want = run(jnp.asarray(ws_np), jnp.asarray(xs_np))
    jgw, jgx = jax.grad(lambda w, x: jnp.sum(run(w, x) ** 2),
                        argnums=(0, 1))(jnp.asarray(ws_np),
                                        jnp.asarray(xs_np))
    ws = torch.from_numpy(ws_np).requires_grad_()
    xs = torch.from_numpy(xs_np).requires_grad_()
    got = run_pipeline(lambda w, x: torch.tanh(x @ w), ws, xs)
    (got ** 2).sum().backward()
    _close(got.detach(), want, FWD, "out")
    _close(ws.grad, jgw, GRAD, "ws")
    _close(xs.grad, jgx, GRAD, "xs")


@pytest.mark.parametrize("world", [2, 4])
def test_stages_match_jax_run_pipeline(world, ranks, jax_oracle):
    for r, res in enumerate(ranks[world]):
        _close(res["pipeline/pipelined/0"], jax_oracle[f"{world}/out"], FWD,
               f"out on {r}")
        gw, gx = res["pipeline/per-rank/0"], res["pipeline/per-rank/1"]
        _close(gw, jax_oracle[f"{world}/gw"][r], GRAD, f"stage {r}'s grad")
        if r == 0:
            _close(gx, jax_oracle[f"{world}/gx"], GRAD, "input's grad")
        else:
            assert np.abs(gx).max() == 0


@pytest.mark.parametrize("world", [2, 4])
def test_schedule_equals_the_sequential_chain(world, ranks):
    """Forward on every rank; dist_check held the gradients per rank."""
    for res in ranks[world]:
        _close(res["pipeline/pipelined/0"], res["pipeline/sequential/0"],
               FWD)


def test_ring_permute_on_one_rank_is_the_identity(world1):
    x = torch.arange(4.0, requires_grad=True)
    assert ring_permute(x) is x

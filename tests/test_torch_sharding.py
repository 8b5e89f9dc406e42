"""The port's sharding rules (``repro_torch.models.sharding``), the ZeRO
state layouts (``optim.state_shardings``) and elastic mesh planning
(``train.elastic``) against the JAX package's.

The JAX side runs once in a subprocess with
``--xla_force_host_platform_device_count=8`` on Auto-axis meshes (1, 8, 1),
(2, 2, 2) and (1, 2, 2): for every arch's reduced config (with its
``rules_for_config`` overrides), each parameter's path and
``tree_param_specs`` spec, and the ``state_shardings`` specs of AdamW and
Adafactor.  The port computes the same on a ``MeshLayout`` of the same
shape (no ranks needed) and must give the same entries, dimension by
dimension (a JAX spec shorter than its array is padded with None).
Exact equality; no tolerance.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch._tree import tree_leaves
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import build_model
from repro_torch.models import sharding as sh
from repro_torch.optim import make_optimizer, state_shardings
from repro_torch.train import elastic

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = [(1, 8, 1), (2, 2, 2), (1, 2, 2)]
AXES = ("pod", "data", "model")

JAX_ORACLE = """
import json, sys
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import ARCH_IDS, get_config
from repro.models import build_model, sharding as shm
from repro.optim import make_optimizer
from repro.optim.api import state_shardings

def entry(e):
    return list(e) if isinstance(e, tuple) else e

def spec(p, ndim):
    out = [entry(e) for e in p]
    return out + [None] * (ndim - len(out))

out = {}
for shape in %s:
    mesh = jax.make_mesh(shape, ("pod", "data", "model"),
                         axis_types=(AxisType.Auto,) * 3)
    tag = "x".join(map(str, shape))
    with shm.use_mesh(mesh):
        out[tag + "/logical"] = [
            spec(shm.logical_spec(*a), len(a)) for a in
            (("batch", None), ("fsdp", "model"), ("model", "data", None))]
    for arch in ARCH_IDS:
        cfg = get_config(arch, reduced=True)
        params = build_model(cfg).init(jax.random.PRNGKey(0))
        shm.rules_for_config(cfg)
        with shm.use_mesh(mesh):
            specs = shm.tree_param_specs(params)
        shm.set_rule_overrides(())
        leaves = jax.tree_util.tree_leaves_with_path(params)
        sl = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
        out[f"{tag}/{arch}/params"] = [
            ["/".join(str(getattr(k, "key", getattr(k, "idx", ""))) for k in
                      path), spec(s, l.ndim)]
            for (path, l), s in zip(leaves, sl)]
        for name in ("adamw", "adafactor"):
            opt = make_optimizer(get_config(arch, reduced=True,
                                            optimizer=name))
            st = state_shardings(opt, specs, params, mesh)
            fields = {"adamw": ("m", "v"), "adafactor": ("vr", "vc")}[name]
            for f in fields:
                shs = jax.tree_util.tree_leaves(getattr(st, f))
                shapes = [l.shape for _, l in leaves]
                if f == "vr":
                    shapes = [s[:-1] if len(s) >= 2 else s for s in shapes]
                if f == "vc":
                    shapes = [s[:-2] + s[-1:] if len(s) >= 2 else (1,)
                              for s in shapes]
                out[f"{tag}/{arch}/{name}/{f}"] = [
                    spec(x.spec, len(s)) for x, s in zip(shs, shapes)]
json.dump(out, open(sys.argv[1], "w"))
""" % (MESHES,)


def _entry(e):
    return list(e) if isinstance(e, tuple) else e


def _spec(p, ndim):
    out = [_entry(e) for e in p]
    return out + [None] * (ndim - len(out))


@pytest.fixture(scope="module")
def jax_specs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_specs") / "specs.json"
    proc = subprocess.run(
        [sys.executable, "-c", JAX_ORACLE, str(out)], capture_output=True,
        text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=8"})
    assert proc.returncode == 0, proc.stderr[-6000:]
    return json.loads(out.read_text())


def _layout(shape):
    return sh.MeshLayout(AXES, shape)


def _port_specs(arch, shape):
    cfg = get_config(arch, reduced=True)
    params = build_model(cfg, device="cpu").param_tree()
    sh.rules_for_config(cfg)
    try:
        with sh.use_mesh(_layout(shape)):
            specs = sh.tree_param_specs(params)
    finally:
        sh.set_rule_overrides(())
    return params, specs


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_jax(arch, shape, jax_specs):
    params, specs = _port_specs(arch, shape)
    tag = "x".join(map(str, shape))
    want = jax_specs[f"{tag}/{arch}/params"]
    paths = tree_leaves(sh.tree_paths(params))
    got = [[p, _spec(s, leaf.ndim)] for p, s, leaf in
           zip(paths, tree_leaves(specs), tree_leaves(params))]
    assert got == want
    assert all(isinstance(s, sh.PartitionSpec) for s in tree_leaves(specs))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_shardings_match_jax(arch, shape, jax_specs):
    params, specs = _port_specs(arch, shape)
    tag = "x".join(map(str, shape))
    for name, fields in (("adamw", ("m", "v")), ("adafactor", ("vr", "vc"))):
        opt = make_optimizer(get_config(arch, reduced=True, optimizer=name))
        st = state_shardings(opt, specs, params, _layout(shape))
        assert st.step == ()
        for f in fields:
            got = [_spec(s, len(s)) for s in tree_leaves(getattr(st, f))]
            assert got == jax_specs[f"{tag}/{arch}/{name}/{f}"], (name, f)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_logical_specs_match_jax(shape, jax_specs):
    tag = "x".join(map(str, shape))
    with sh.use_mesh(_layout(shape)):
        got = [_spec(sh.logical_spec(*a), len(a)) for a in
               (("batch", None), ("fsdp", "model"), ("model", "data", None))]
        assert sh.batch_axes() == ("pod", "data")
    assert got == jax_specs[f"{tag}/logical"]


def test_validate_spec_replicates_what_does_not_divide():
    with sh.use_mesh(_layout((1, 4, 2))):
        assert sh.validate_spec(("model", ("pod", "data")), (51865, 8)) == \
            (None, ("pod", "data"))
        assert sh.param_spec("embed/table", (51865, 8)) == \
            (None, ("pod", "data"))
    assert sh.get_mesh() is None
    assert sh.param_spec("embed/table", (8, 8)) == (None, None)
    assert sh.batch_axes() == ("data",)


@pytest.fixture
def world1(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_plan_mesh_and_its_refusals(world1):
    mesh = elastic.plan_mesh()
    assert tuple(mesh.mesh_dim_names) == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)
    with pytest.raises(ValueError, match="healthy"):
        elastic.plan_mesh(2)
    with pytest.raises(ValueError, match=">= 1"):
        elastic.plan_mesh(0)


def test_reshard_tree_on_one_rank_is_the_whole_tree(world1):
    cfg = get_config("tinyllama-1.1b", reduced=True)
    tree = build_model(cfg, device="cpu").param_tree()
    local = elastic.reshard_tree(tree, elastic.plan_mesh())
    for a, b in zip(tree_leaves(tree), tree_leaves(local)):
        assert torch.equal(a, b)


def test_host_mesh_default_layout(world1):
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh()
    assert tuple(mesh.mesh_dim_names) == AXES and tuple(mesh.shape) == \
        (1, 1, 1)
    with pytest.raises(ValueError, match="holds 2 ranks"):
        make_host_mesh((1, 2, 1), AXES)

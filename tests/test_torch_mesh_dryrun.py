"""The per-rank dry run of a mesh against the JAX package and the one-card
dry run, on the CPU.

The mesh specs (``batch_spec``, the training, prefill and decode inputs
and the decode state) equal JAX's on the production ``AbstractMesh`` es
for every arch and applicable shape; the ``(1, 1, 1)`` per-rank record
equals the one-card record of each family and kind, collectives zero; the
first and the last rank of a mesh count the same; a full-size cell runs
on meta without allocating; the dry run and the roofline write their
mesh records and tables; and every collective of the package goes
through ``core/distributed.py``.
"""
import json
import pathlib
import re
import resource

import pytest
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_get_config
from repro.configs import get_shape as jax_get_shape
from repro.launch import specs as jax_specs
from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeConfig, get_config,
                                 shape_applicable)
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import MESHES, stand_in_mesh
from repro_torch.models.sharding import MeshLayout

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: the JAX production meshes and the port's layouts of the same names
JAX_MESHES = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}
#: one representative of each family
FAMILIES = ("tinyllama-1.1b", "kimi-k2-1t-a32b", "zamba2-1.2b",
            "rwkv6-1.6b", "whisper-base", "internvl2-2b")


def _entry(e):
    """A spec entry as a tuple of axis names (JAX may keep a one-axis
    tuple or the name)."""
    if e is None:
        return ()
    return tuple(e) if isinstance(e, (tuple, list)) else (e,)


def _same(port_spec, jax_spec, ndim):
    want = list(jax_spec) + [None] * (ndim - len(jax_spec))
    assert [_entry(e) for e in port_spec] == [_entry(e) for e in want]


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
def test_mesh_specs_match_jax(mesh_name):
    """Every arch and applicable shape: the batch, the training and
    prefill inputs, the decode token and every decode-state leaf take
    JAX's spec on the same mesh (the state's whole shapes too)."""
    shape, axes = JAX_MESHES[mesh_name]
    jmesh = AbstractMesh(shape, axes)
    mesh = MeshLayout(axes, shape)
    for n in (1, 8, 16, 32, 128, 256):
        assert _entry(S.batch_spec(mesh, n)) == _entry(
            jax_specs.batch_spec(jmesh, n))
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        for sh in SHAPES:
            if not shape_applicable(cfg, sh)[0]:
                continue
            jsh = jax_get_shape(sh.name)
            for port_fn, jax_fn in (
                    (S.mesh_train_batch_specs, jax_specs.train_batch_specs),
                    (S.mesh_prefill_batch_specs,
                     jax_specs.prefill_batch_specs)):
                structs, specs = port_fn(cfg, sh, mesh)
                jstructs, jsh_specs = jax_fn(jcfg, jsh, jmesh)
                assert sorted(specs) == sorted(jsh_specs)
                for k, t in structs.items():
                    assert tuple(t.shape) == jstructs[k].shape
                    _same(specs[k], jsh_specs[k].spec, t.ndim)
            if sh.kind != "decode":
                continue
            _, tok_spec = S.mesh_decode_input_specs(cfg, sh, mesh)
            _, jtok = jax_specs.decode_input_specs(jcfg, jsh, jmesh)
            _same(tok_spec, jtok.spec, 1)
            state, specs = S.mesh_decode_state_specs(cfg, sh, mesh)
            jstate, jspecs = jax_specs.decode_state_specs(jcfg, jsh, jmesh)
            assert state._fields == jstate._fields, arch
            for t, spec, jt, js in zip(state, specs, jstate, jspecs):
                assert tuple(t.shape) == jt.shape, (arch, sh.name)
                _same(spec, js.spec, t.ndim)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_one_rank_mesh_equals_one_card(arch, kind):
    """The per-rank dry run on a (1, 1, 1) mesh counts what one card's
    does: FLOPs, bytes, kernel calls, arguments and peak; no
    collectives."""
    cfg = get_config(arch, reduced=True)
    shape = ShapeConfig("test", 16, 8, kind)
    card = dryrun.dry_run(cfg, shape)
    rank = dryrun.mesh_dry_run(cfg, shape, (1, 1, 1))
    assert (rank["rank"], rank["chips"], rank["mesh_shape"]) == (0, 1,
                                                                  [1, 1, 1])
    for key in ("cost", "kernels", "memory", "tokens"):
        assert rank[key] == card[key], key
    assert rank["collectives"]["raw_total"] == 0
    assert card["collectives"]["raw_total"] == 0


@pytest.mark.parametrize("arch,shape,mesh", [
    ("qwen1.5-0.5b", ShapeConfig("t", 16, 8, "train"), (2, 2, 2)),
    ("zamba2-1.2b", ShapeConfig("d", 32, 1, "decode"), (1, 4, 2))])
def test_first_and_last_rank_count_the_same(arch, shape, mesh):
    """The ranks are symmetric: rank 0 and the last rank of the mesh
    count the same FLOPs, bytes, kernel calls, peak and collectives."""
    cfg = get_config(arch, reduced=True)
    first = dryrun.mesh_dry_run(cfg, shape, mesh, rank=0)
    last = dryrun.mesh_dry_run(cfg, shape, mesh, rank=8 - 1)
    for key in ("cost", "kernels", "memory", "collectives"):
        assert first[key] == last[key], key
    assert first["collectives"]["raw_total"] > 0


def test_full_size_mesh_cell_dry_runs_on_meta_without_allocating():
    """kimi-k2 (1 T parameters) x train_4k on a rank of (2, 16, 16):
    every layer of every microbatch counted, a step of all-gathers,
    reduce-scatters and all-reduces, and the process's resident memory
    grows by less than 2 GB."""
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    rec = dryrun.run_cell("kimi-k2-1t-a32b", "train_4k", save=False,
                          verbose=False, mesh_shape=MESHES["multi"])
    grown_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    assert (rec["chips"], rec["mesh_shape"], rec["mesh"]) == (
        512, [2, 16, 16], "h100_2x16x16")
    coll = rec["collectives"]
    for op in ("all-reduce", "all-gather", "reduce-scatter"):
        assert coll[op] > 0 and coll["n_" + op] > 0, op
    # a rank's share of the model: 1/512 of the parameters at most twice
    # over (params and gradient regions) beside the optimizer state
    assert rec["memory"]["argument_size_in_bytes"] < 2 * 2 * rec[
        "n_params"] / 256
    assert grown_kb < 2 * 1024 * 1024


def test_mesh_records_and_tables(tmp_path):
    """``dryrun --mesh both`` writes a record a mesh (rank, chips,
    mesh_shape, the note, collectives above zero) and a skip with JAX's
    reason; ``roofline --mesh both`` prints both tables with a
    collective term; the one-card files keep their names."""
    d = tmp_path / "d"
    for shape in ("decode_32k", "long_500k"):
        assert dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", shape,
                            "--mesh", "both", "--out", str(d)]) == 0
    for name, chips, mesh in (("h100_16x16", 256, [1, 16, 16]),
                              ("h100_2x16x16", 512, [2, 16, 16])):
        rec = json.loads((d / f"qwen1.5-0.5b_decode_32k_{name}.json")
                         .read_text())
        assert (rec["rank"], rec["chips"], rec["mesh_shape"]) == (0, chips,
                                                                  mesh)
        assert "not measured" in rec["note"] and "rank" in rec["note"]
        assert rec["collectives"]["raw_total"] > 0
        skip = json.loads((d / f"qwen1.5-0.5b_long_500k_{name}.json")
                          .read_text())
        assert skip["skipped"].startswith("full quadratic attention")
        row = roofline.analyze_cell(rec)
        assert row["chips"] == chips and row["collective_s"] > 0
    assert not list(d.glob("*_h100.json"))
    assert roofline.main(["--dryrun-dir", str(d), "--out", str(tmp_path),
                          "--mesh", "both"]) == 0
    for name in ("h100_16x16", "h100_2x16x16"):
        md = (tmp_path / f"roofline_torch_{name}.md").read_text()
        assert "collective GB / rank" in md and "SKIP" in md


def test_stand_in_mesh_refuses_a_second_group():
    with stand_in_mesh((2, 16, 16), rank=37) as mesh:
        assert tuple(mesh.get_coordinate()) == (0, 2, 5)
        with pytest.raises(RuntimeError, match="already exists"):
            with stand_in_mesh((1, 1, 1)):
                pass
    assert not dist.is_initialized()


def test_every_collective_goes_through_core_distributed():
    """No ``torch.distributed`` collective is called outside
    ``core/distributed.py`` (``dist_check``'s barriers aside)."""
    call = re.compile(
        r"\bdist\.(all_reduce|all_gather\w*|reduce_scatter\w*|"
        r"all_to_all\w*|broadcast\w*|reduce|gather|scatter|send|recv|"
        r"isend|irecv|batch_isend_irecv)\(")
    found = []
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        if path.name == "distributed.py" and path.parent.name == "core":
            continue
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if call.search(line):
                found.append(f"{path.name}:{i}: {line.strip()}")
    assert not found, found

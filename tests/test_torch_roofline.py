"""The port's shape cells, H100 hardware model, dry run and roofline
against the JAX package on the CPU.

The assigned shapes and their skips, the parameter counts, the
``HardwareModel`` formula (H100 figures in the port, none of the TPU's),
``analyze_cell`` with JAX's constants, and the dry run's microbatched
training step are held to the JAX package.  The dry run counts the same
FLOPs, bytes and kernel calls on meta as over a real CPU run of the same
step, for every family and kind; each kernel's work function gives
PERF.md's bound at the main path's shapes; a decode step past
``max_seq`` equals JAX's.
"""
import dataclasses
import importlib.util
import os
import pathlib
import re
import resource

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import get_shape as jax_get_shape
from repro.configs import shape_applicable as jax_shape_applicable
from repro.core import HardwareModel as JaxHardwareModel
from repro.core import MRCost as JaxMRCost
from repro.launch import roofline as jax_roofline
from repro.models import build_model as jax_build_model
from repro.optim import make_optimizer as jax_make_optimizer
from repro_torch._tree import tree_leaves
from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeConfig, get_config,
                                 get_shape, shape_applicable)
from repro_torch.core import HardwareModel, get_engine, sort_plan
from repro_torch.core import costmodel
from repro_torch.interop import lm_params_from_numpy
from repro_torch.kernels import (bincount, bitonic_sort, flash_attention,
                                 prefix_scan, ssm_scan)
from repro_torch.launch import dryrun, roofline
from repro_torch.optim import make_optimizer

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: one representative of each family
FAMILIES = ("tinyllama-1.1b", "kimi-k2-1t-a32b", "zamba2-1.2b",
            "rwkv6-1.6b", "whisper-base", "internvl2-2b")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- configs
def test_shapes_and_skips_match_jax():
    """``SHAPES``, ``get_shape`` and ``shape_applicable`` equal JAX's for
    every (arch, shape) cell, reasons included: 8 quadratic archs skip
    ``long_500k``."""
    assert ARCH_IDS == JAX_ARCH_IDS
    assert [dataclasses.astuple(s) for s in SHAPES] == \
        [dataclasses.astuple(s) for s in JAX_SHAPES]
    skipped = 0
    for s in JAX_SHAPES:
        assert dataclasses.astuple(get_shape(s.name)) == \
            dataclasses.astuple(jax_get_shape(s.name))
        for arch in ARCH_IDS:
            got = shape_applicable(get_config(arch), get_shape(s.name))
            assert got == jax_shape_applicable(jax_get_config(arch), s)
            skipped += not got[0]
    assert skipped == 8
    with pytest.raises(KeyError):
        get_shape("train_8k")


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_match_jax(arch, reduced):
    cfg, jcfg = (get_config(arch, reduced=reduced),
                 jax_get_config(arch, reduced=reduced))
    assert cfg.n_params() == jcfg.n_params()
    assert cfg.n_active_params() == jcfg.n_active_params()


# ------------------------------------------------------- hardware model
def test_hardware_model_matches_jax_formula_with_h100_defaults():
    """Built with the same keywords, both ``shuffle_time`` s agree (1e-12
    relative) on a sort query's measured cost from the port's engine,
    copied field by field into JAX's ``MRCost``; the port's defaults are
    the H100's, and no TPU figure is left in the port."""
    x = np.random.default_rng(3).normal(size=4096).astype(np.float32)
    res = get_engine("kernel", device="cpu").compile(sort_plan(4096, 64))(
        x, key=1)
    cost = res.stats.to_mrcost()
    jcost = JaxMRCost(rounds=cost.rounds, communication=cost.communication,
                      internal_time=cost.internal_time,
                      max_reducer_io=cost.max_reducer_io)
    assert cost.rounds >= 2 and cost.communication > 0
    for kw in ({"chips": 1}, {"chips": 4, "peak_flops": 1e15,
                              "hbm_bw": 2e12, "ici_bw_per_link": 3e10,
                              "latency_s": 7e-6}):
        for item in (4, 8):
            got = HardwareModel(**kw).shuffle_time(cost, item)
            if len(kw) > 1:
                want = JaxHardwareModel(**kw).shuffle_time(jcost, item)
                assert got == pytest.approx(want, rel=1e-12)
            assert got > 0
    hw = HardwareModel(chips=1)
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw_per_link) == (
        989e12, 3.35e12, 25e9)
    assert costmodel.HBM_BYTES == 80e9 and costmodel.PEAK_FLOPS_F32 == 67e12
    assert [f.name for f in dataclasses.fields(HardwareModel)] == \
        [f.name for f in dataclasses.fields(JaxHardwareModel)]
    tpu = re.compile(r"\b(197e12|819e9|50e9)\b")
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        assert not tpu.findall(path.read_text()), path


# --------------------------------------------------------------- roofline
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_analyze_cell_matches_jax(shape, monkeypatch):
    """The port's ``analyze_cell`` on a dry-run record, with JAX's
    constants, equals JAX's on the same record (its ``_load`` patched to
    return it, no depth proxies) within 1e-12 relative."""
    arch = "qwen1.5-0.5b"
    rec = dryrun.run_cell(arch, shape, save=False, verbose=False)
    mesh = rec["mesh"]
    monkeypatch.setattr(jax_roofline, "_load", lambda name: dict(rec)
                        if name == f"{arch}_{shape}_{mesh}" else None)
    want = jax_roofline.analyze_cell(arch, shape, mesh, 1)
    got = roofline.analyze_cell(dict(rec), peak_flops=jax_roofline.PEAK_FLOPS,
                                hbm_bw=jax_roofline.HBM_BW,
                                link_bw=jax_roofline.ICI_BW,
                                hbm_gb=jax_roofline.HBM_GB)
    for k in ("compute_s", "memory_s", "collective_s", "roofline_frac",
              "model_flops_per_chip", "useful_ratio", "per_device_gb"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    assert got["dominant"] == want["dominant"]
    assert got["fits_80gb"] == want["fits_16gb"]
    assert want["method"].startswith("raw")


def test_roofline_cli_writes_the_table(tmp_path):
    """``dryrun --arch/--shape`` then ``roofline`` over its directory: a
    record, a skip with JAX's reason, and the table with ``fits 80 GB``."""
    for shape in ("decode_32k", "long_500k"):
        assert dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", shape,
                            "--out", str(tmp_path / "d")]) == 0
    assert roofline.main(["--dryrun-dir", str(tmp_path / "d"), "--out",
                          str(tmp_path)]) == 0
    md = (tmp_path / "roofline_torch_h100.md").read_text()
    assert "fits 80 GB" in md and "SKIP: full quadratic attention" in md
    assert "| qwen1.5-0.5b | decode_32k |" in md


# ------------------------------------------------------- the train step
@pytest.fixture
def jax_dryrun(monkeypatch):
    """``repro.launch.dryrun``, imported after JAX has started (its import
    sets ``XLA_FLAGS`` for 512 host devices, which must not reach later
    JAX tests in this process); ``XLA_FLAGS`` is put back."""
    jax.devices()
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import dryrun as jd
    return jd


def _jax_params(jcfg, seed=0):
    tree = jax.tree_util.tree_map(
        np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    return jax.tree_util.tree_map(
        lambda a: (a + rng.normal(size=a.shape) * 0.1 * (np.abs(a).mean()
                                                         + 0.5))
        .astype(a.dtype), tree)


def _rel_l2(got, want) -> float:
    g = np.concatenate([np.asarray(t, np.float64).ravel() for t in got])
    w = np.concatenate([np.asarray(t, np.float64).ravel() for t in want])
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-1.2b"])
def test_microbatched_train_step_matches_jax(arch, jax_dryrun):
    """``build_train_step`` at ``grad_accum = 2``: the loss and the
    updated parameters and AdamW moments after two steps equal the jitted
    JAX ``dryrun.build_train_step`` from the same params (1e-5 relative,
    the loss; 1e-5 relative L2 over each tree)."""
    jcfg = jax_get_config(arch, reduced=True, grad_accum=2)
    tcfg = get_config(arch, reduced=True, grad_accum=2)
    tree = _jax_params(jcfg)
    rng = np.random.default_rng(9)
    batches = []
    for _ in range(2):
        toks = rng.integers(0, tcfg.vocab_size, (4, 17)).astype(np.int32)
        batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    jmodel, jopt = jax_build_model(jcfg), jax_make_optimizer(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    jstep = jax.jit(jax_dryrun.build_train_step(jcfg, jmodel, jopt))
    model = lm_params_from_numpy(tree, tcfg, device="cpu")
    opt = make_optimizer(tcfg)
    params = model.trainable_tree()
    state = opt.init(params)
    step = dryrun.build_train_step(tcfg, model, opt)
    for batch in batches:
        jparams, jstate, jloss = jstep(
            jparams, jstate, jax.tree_util.tree_map(jnp.asarray, batch))
        params, state, loss = step(params, state, {
            k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert _rel_l2([p.detach() for p in tree_leaves(params)],
                   jax.tree_util.tree_leaves(jparams)) <= 1e-5
    assert int(state.step) == 2
    # the first step's lr is 0 (warmup): AdamW's moments carry the summed
    # microbatch gradients, which the parameters barely show (their scale,
    # the division by accum, is lost to the global-norm clip in both)
    for name in ("m", "v"):
        assert _rel_l2(tree_leaves(getattr(state, name)),
                       jax.tree_util.tree_leaves(getattr(jstate, name))) \
            <= 1e-5, name


# ----------------------------------------------------- the dry-run count
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_dry_run_count_does_not_depend_on_the_device(arch, kind):
    """The counter over a cell's step on meta (stand-ins) and over the
    same step run for real on the CPU (drawn params and inputs): the same
    FLOPs, bytes and kernel calls."""
    cfg = get_config(arch, reduced=True)
    shape = ShapeConfig("test", 16, 8, kind)
    got = {}
    for device in ("meta", "cpu"):
        model, step, args = dryrun.cell_inputs(cfg, shape, device)
        got[device] = dryrun.record(cfg, shape,
                                    dryrun.count(model, step, args))
    meta, cpu = got["meta"], got["cpu"]
    assert meta["cost"] == cpu["cost"]
    assert meta["kernels"] == cpu["kernels"]
    assert meta["cost"]["flops"] > 0 and meta["memory"]["peak_bytes"] > \
        meta["memory"]["argument_size_in_bytes"] > 0
    if kind == "prefill" and cfg.family != "ssm":    # RWKV6: no attention
        assert meta["kernels"]["flash_attention"] > 0
    if kind == "train" and cfg.family in ("hybrid", "ssm"):
        assert meta["kernels"]["ssm_scan.bwd"] > 0


def test_full_size_cell_dry_runs_on_meta_without_allocating():
    """kimi-k2 (1 T parameters) x prefill_32k dry-runs on meta: every
    layer counted, a peak in the terabytes, and the process's resident
    memory grows by less than 2 GB."""
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    rec = dryrun.run_cell("kimi-k2-1t-a32b", "prefill_32k", save=False,
                          verbose=False)
    grown_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    assert rec["kernels"] == {"flash_attention": 61}
    assert rec["memory"]["argument_size_in_bytes"] > 2e12
    assert rec["cost"]["flops"] >= 2 * rec["n_active_params"] * rec["tokens"]
    assert grown_kb < 2 * 1024 * 1024


# ------------------------------------------------------- work functions
def test_work_functions_give_the_bounds_of_perf_md():
    """Each kernel's work function, over ``chip_smoke``'s main-path
    shapes, gives the bound PERF.md's table lists (ms, three decimals):
    flash 0.278 (TinyLlama's and zamba2's prefill attention, bf16, at 989
    TFLOP/s), ``bitonic_sort`` 0.321 and ``bincount_tiles`` 0.200 (a sort
    query's two shuffles of 2^24 keys), ``ssm_scan`` 0.240, its backward
    0.401, ``prefix_scan`` 0.100, ``bincount`` 0.020."""
    cs = _chip_smoke()
    bf16, f32, i32 = torch.bfloat16, torch.float32, torch.int32

    def total(works, rate=None):
        return round(cs.bound_ms(sum(w[0] for w in works),
                                 sum(w[1] for w in works), rate), 3)
    flash = [flash_attention.flash_attention_work(*cs.FLASH_MAIN[:6], True,
                                                  bf16),
             flash_attention.flash_attention_work(8, 32, 32, 2048, 2048, 64,
                                                  True, bf16)]
    assert total(flash, costmodel.PEAK_FLOPS_BF16) == 0.278
    sort_tiles = ((4096, 4096), (12288, 4096))
    assert total([bitonic_sort.bitonic_sort_work(r, n, i32, i32)
                  for r, n in sort_tiles]) == 0.321
    assert total([bincount.bincount_tiles_work(r, n, 2048)
                  for r, n in sort_tiles]) == 0.200
    assert total([ssm_scan.ssm_scan_work(*s, f32, f32)
                  for s in cs.SSM_MAIN]) == 0.240
    assert total([ssm_scan.ssm_scan_bwd_work(*s[:3], f32, f32)
                  for s in cs.SSM_BWD_MAIN]) == 0.401
    assert total([prefix_scan.prefix_scan_work(r, n, getattr(torch, dt))
                  for r, n, dt, _ in cs.SCAN_MAIN]) == 0.100
    assert total([bincount.bincount_work(*cs.BINCOUNT_MAIN)]) == 0.020


def test_flash_work_counts_the_unmasked_pairs():
    """Causal with s_q <= s_k: s_q (s_q + 1) / 2 pairs; past s_k every
    query reads all s_k keys; bidirectional s_q s_k."""
    f = flash_attention.flash_attention_work
    assert f(1, 1, 1, 4, 4, 1, True, torch.float32)[0] == 4 * 10
    assert f(1, 1, 1, 6, 4, 1, True, torch.float32)[0] == 4 * (10 + 8)
    assert f(1, 1, 1, 3, 5, 1, False, torch.float32) == (4 * 15,
                                                        4 * (2 * 3 + 2 * 5))


# ------------------------------------------------------- past max_seq
def test_decode_past_max_seq_matches_jax():
    """One zamba2 decode step at position 9000, past ``max_seq`` (8192):
    rope is computed from the position in both packages, so the logits and
    the state equal JAX's (2e-4) on a seeded random cache."""
    jcfg = jax_get_config("zamba2-1.2b", reduced=True)
    tcfg = get_config("zamba2-1.2b", reduced=True)
    pos, T, b = 9000, 9008, 2
    assert pos > tcfg.max_seq
    tree = _jax_params(jcfg)
    jmodel = jax_build_model(jcfg)
    model = lm_params_from_numpy(tree, tcfg, device="cpu")
    rng = np.random.default_rng(11)
    jstate = jmodel.init_decode_state(b, T)
    fields = {name: rng.normal(size=np.shape(v)).astype(np.float32) * 0.5
              for name, v in jstate._asdict().items() if name != "pos"}
    jstate = jstate._replace(pos=jnp.full((b,), pos, jnp.int32),
                             **{k: jnp.asarray(v) for k, v in fields.items()})
    tstate = model.init_decode_state(b, T)
    tstate = tstate._replace(pos=torch.full((b,), pos, dtype=torch.int32),
                             **{k: torch.from_numpy(v.copy())
                                for k, v in fields.items()})
    tok = rng.integers(0, tcfg.vocab_size, b).astype(np.int32)
    jl, jout = jax.jit(jmodel.decode_step)(jax.tree_util.tree_map(
        jnp.asarray, tree), jnp.asarray(tok), jstate)
    tl, tout = model.decode_step(torch.from_numpy(tok), tstate)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4,
                               atol=2e-4)
    for name in fields:
        np.testing.assert_allclose(getattr(tout, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   rtol=2e-4, atol=2e-4, err_msg=name)
    assert tout.pos.tolist() == [pos + 1] * b

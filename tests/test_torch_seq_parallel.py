"""Megatron sequence parallelism (``seq_shard_activations``) in one
process: the JAX package's rule that a sequence the "model" axis does not
divide stays whole, a one-rank "model" axis, the leaves whose gradients
the mesh step sums over "model", the sequence-parallel pair on a one-rank
gloo group under a checkpoint, and the activation memory a rank keeps.

The runs of every family on four gloo ranks against the JAX Trainer, the
sharded prefill, the counts on gloo against the per-rank dry run and the
two planted faults ride the world-4 spawn of
``tests/test_torch_parallel_train.py`` (``dist_check --cases train-sp``).
Every count here is the per-rank dry run's on PyTorch's stand-in process
group (``launch.mesh.stand_in_mesh``), on meta.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ShapeConfig, get_config, get_shape
from repro_torch.core import distributed as D
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import stand_in_mesh
from repro_torch.models import build_model, sharding
from repro_torch.models.sharding import config_rules, tree_paths
from repro_torch._tree import tree_leaves
from repro_torch.optim import make_optimizer
from repro_torch.train.zero import MeshStep

COUNTED = ("cost", "kernels", "collectives")


def _counts(arch, shape, mesh, **over):
    cfg = get_config(arch, reduced=True, **over)
    rec = dryrun.mesh_dry_run(cfg, ShapeConfig(*shape), mesh)
    return {k: rec[k] for k in COUNTED}


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "zamba2-1.2b",
                                  "rwkv6-1.6b"])
def test_a_length_model_does_not_divide_stays_whole(arch):
    """18 positions over four "model" ranks: the flag takes the plain
    tensor-parallel path, the same collectives and counts; 16 positions
    split, and the regions' all-reduces become all-gathers and
    reduce-scatters."""
    over = dict(grad_accum=2)
    uneven = ("train", 18, 8, "train")
    assert _counts(arch, uneven, (1, 1, 4), seq_shard_activations=True,
                   **over) == _counts(arch, uneven, (1, 1, 4), **over)
    even = ("train", 16, 8, "train")
    plain = _counts(arch, even, (1, 1, 4), **over)["collectives"]
    sp = _counts(arch, even, (1, 1, 4), seq_shard_activations=True,
                 **over)["collectives"]
    assert sp["n_all-reduce"] < plain["n_all-reduce"]
    assert sp["n_reduce-scatter"] > plain["n_reduce-scatter"]
    assert sp["n_all-gather"] > plain["n_all-gather"]


@pytest.mark.parametrize("mesh,shape", [
    ((1, 1, 1), ("train", 16, 8, "train")),
    ((1, 4, 1), ("train", 16, 8, "train")),
    ((1, 1, 4), ("decode", 32, 4, "decode")),
    ((1, 1, 4), ("prefill", 18, 4, "prefill"))])
def test_the_flag_changes_nothing_where_nothing_splits(mesh, shape):
    """A "model" axis of one rank, a decode step's one position, a
    prompt of 18 on four ranks: the flag leaves the counts as they are."""
    assert _counts("qwen1.5-0.5b", shape, mesh,
                   seq_shard_activations=True) == _counts(
        "qwen1.5-0.5b", shape, mesh)


def _summed_paths(arch, mesh, seq=16):
    """The '/'-paths of the leaves whose gradient the mesh step sums over
    "model" after a step of ``seq`` positions on rank 0 of ``mesh``."""
    cfg = get_config(arch, reduced=True, seq_shard_activations=True)
    with stand_in_mesh(mesh, 0) as m, config_rules(cfg), \
            dryrun.cpp_meta_kernels():
        model = build_model(cfg, device="meta")
        paths = tree_leaves(tree_paths(model.param_tree()))
        step = MeshStep(model, make_optimizer(cfg), m, lambda t: 1e-3)
        b = 8 // (mesh[0] * mesh[1])
        rows = {k: torch.zeros((b, seq), dtype=torch.int32, device="meta")
                for k in ("tokens", "labels")}
        step._grads(rows)
        return {paths[i] for i, lay in enumerate(step.layouts)
                if step._model_summed(i, lay)}


def test_the_leaves_used_on_the_slice_are_summed_over_model():
    """qwen at (1, 1, 4): the norm scales and the attention biases (whole
    on every rank) are the ranks' parts; what "model" splits (the
    embedding, the projections) is not summed; at 18 positions (no
    split) nothing is."""
    assert _summed_paths("qwen1.5-0.5b", (1, 1, 4)) == {
        "final_norm/scale", "layers/attn_norm/scale",
        "layers/mlp_norm/scale", "layers/attn/bq", "layers/attn/bk",
        "layers/attn/bv"}
    assert _summed_paths("qwen1.5-0.5b", (1, 1, 4), seq=18) == set()


def test_the_sequence_parallel_pair_under_a_checkpoint(tmp_path):
    """Enter (all-gather of the sequence, reduce-scatter back) and leave
    (reduce-scatter, all-gather back) on a one-rank gloo group under a
    checkpoint: the gradients of a column- and a row-parallel matmul
    between them equal the function without collectives, and a strided
    gradient reaches the collectives contiguous."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                            rank=0, world_size=1)
    try:
        g = torch.Generator().manual_seed(0)
        x, w1, w2 = (torch.randn(*sh, generator=g) for sh in
                     ((2, 8, 16), (16, 32), (32, 16)))

        def f(x, w1, w2, sp):
            h = D.enter_sequence(x, dist.group.WORLD) if sp else x
            y = torch.relu(h @ w1) @ w2
            y = D.leave_sequence(y, dist.group.WORLD) if sp else y
            return (y.transpose(1, 2) ** 2).sum()   # a strided gradient

        grads = []
        for sp in (True, False):
            ins = [t.clone().requires_grad_() for t in (x, w1, w2)]
            checkpoint(f, *ins, sp, use_reentrant=False).backward()
            grads.append([t.grad for t in ins])
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    finally:
        dist.destroy_process_group()


def test_a_rank_keeps_less_activation_memory():
    """tinyllama x train_4k on rank 0 of (1, 16, 16), depth cut to 2
    layers at full width: the per-rank dry run's peak with the flag is
    below the plain one (each checkpointed layer keeps its slice)."""
    shape = get_shape("train_4k")
    peaks = []
    for flag in (False, True):
        cfg = get_config("tinyllama-1.1b", n_layers=2,
                         seq_shard_activations=flag)
        peaks.append(dryrun.mesh_dry_run(cfg, shape, (1, 16, 16))
                     ["memory"]["peak_bytes"])
    assert peaks[1] < peaks[0]


def test_tensor_parallel_copy_is_the_identity_on_a_split_sequence():
    """Inside a split sequence every value a rank computes from its slice
    is its part, so ``copy`` enters nothing; ``sum`` still all-reduces
    (the CE's and the router's statistics)."""
    tp = sharding.TensorParallel(None, 4, 1)
    x = torch.ones(2, 8, 3, requires_grad=True)
    token = sharding._SEQ.set(True)
    try:
        assert tp.seq and tp.copy(x) is x
        own = tp.own(x)
        assert own.shape == (2, 2, 3)
        assert own.data_ptr() == x[:, 2:4].data_ptr()
    finally:
        sharding._SEQ.reset(token)
    assert not tp.seq and tp.own(x) is x
    np.testing.assert_array_equal(tp.block(x, 1, 2).detach().numpy(),
                                  x[:, 2:4].detach().numpy())

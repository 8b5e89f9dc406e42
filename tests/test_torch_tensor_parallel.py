"""Tensor, expert and parameter parallelism of the port on one process:
the pieces the mesh ``Trainer`` (``repro_torch.train.zero``) is built
from, held on the CPU against the JAX package or the one-device port.
The multi-rank runs are in tests/test_torch_parallel_train.py.

- The vocab-parallel cross entropy with the logits split in two parts
  (on a leading axis of one tensor) equals ``cross_entropy`` in value
  and gradient, padded vocabulary and loss mask included (1e-6).
- The MoE einsum dispatch over three virtual batch ranks, whose capacity
  groups span them (60 tokens in groups of 16, the last padded on the
  last rank): every rank's positions, keeps, aux loss and dropped
  fraction, and the rows of y put together, equal the JAX ``_moe_einsum``
  and the port's on the whole batch, drops included (positions exactly,
  floats within 2e-5).
- ``TensorLayout``: local, region and gathered shapes, the pod hop's
  shard of a region, and the unit test of a ``"model"`` split.
- The Megatron pair, the region gather and the FSDP gather on a gloo group
  of one rank: identities forward, the sink receiving the gradient.
- A (1, 1, 1) mesh step with every leaf that has a data dimension forced
  through the FSDP gather (reduced qwen1.5-0.5b and zamba2-1.2b, remat
  "full") trains as the one-device step (1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jax_get_config
from repro.models import moe as jm
from repro_torch.configs import get_config
from repro_torch.core import distributed as D
from repro_torch.interop import tree_from_numpy
from repro_torch.models import moe as tm
from repro_torch.models.layers import (cross_entropy,
                                       vocab_parallel_cross_entropy)
from repro_torch.models.sharding import TensorLayout, P, unit_split

RNG = np.random.default_rng(725)


# ------------------------------------------------- vocab-parallel CE
def _split_ce(logits, labels, mask, n_parts):
    """The vocab-parallel CE of ``logits`` split into ``n_parts`` parts on
    a leading axis: the parts' sum keeps each part's own gradient, as
    ``tp.sum`` does, so each part's gradient is 1/n of its rank's."""
    v = logits.shape[-1] // n_parts
    parts = logits.unflatten(-1, (n_parts, v)).movedim(-2, 0)
    first = (torch.arange(n_parts) * v).reshape((n_parts,)
                                                + (1,) * labels.ndim)
    psum = lambda t: t + (t.sum(0, keepdim=True) - t).detach()
    pmax = lambda t: t.amax(0, keepdim=True).expand_as(t)
    return vocab_parallel_cross_entropy(parts, labels, mask, 1e-4, first,
                                        psum, pmax)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n_parts", [2, 4])
def test_vocab_parallel_cross_entropy_matches_cross_entropy(n_parts,
                                                            masked):
    logits = torch.from_numpy(RNG.normal(size=(3, 10, 64)).astype(
        np.float32) * 3)
    logits[..., 60:] = -1e30                  # a padded vocabulary tail
    logits.requires_grad_()
    labels = torch.from_numpy(RNG.integers(0, 60, (3, 10)))
    mask = (torch.from_numpy(RNG.random((3, 10))) > 0.3).float() \
        if masked else None
    want = cross_entropy(logits, labels, mask)
    gw, = torch.autograd.grad(want, logits)
    got = _split_ce(logits, labels, mask, n_parts)
    gg, = torch.autograd.grad(got, logits)
    assert abs(got.item() - want.item()) <= 1e-6 * abs(want.item())
    torch.testing.assert_close(gg * n_parts, gw, rtol=1e-6, atol=1e-6)


# ------------------------------------------- MoE over virtual batch ranks
class VirtualBatch:
    """Rank ``index`` of ``size`` batch ranks in one process.  Each call of
    ``sum`` / ``gather`` answers from ``answers`` (every rank's argument
    of the same call in the previous pass) and records its own argument;
    a few passes settle every answer."""

    def __init__(self, index, size, answers):
        self.index, self.size, self.answers = index, size, answers
        self.calls = []

    def _arg(self, x):
        self.calls.append(x.detach().clone())
        i = len(self.calls) - 1
        if self.answers is None:
            return [x.detach()] * self.size
        return [a[i] for a in self.answers]

    def sum(self, x):
        return torch.stack(self._arg(x)).sum(0)

    def gather(self, x):
        return torch.stack(self._arg(x))


def _virtual_moe(p, cfg, x, n_ranks, group):
    """Each virtual rank's (Routes, MoEOut) of its rows of x."""
    rows = x.shape[0] // n_ranks
    answers = [None] * n_ranks
    real = tm._mesh_batch
    try:
        for _ in range(3):
            out, calls = [], []
            for r in range(n_ranks):
                vb = VirtualBatch(r, n_ranks, answers[0] and answers)
                tm._mesh_batch = lambda vb=vb: vb
                xr = x[r * rows:(r + 1) * rows]
                routes = tm._route_tokens(p, cfg, xr, group,
                                          batch=VirtualBatch(
                                              r, n_ranks,
                                              answers[0] and answers))
                out.append((routes, tm._moe_einsum(p, cfg, xr, group)))
                calls.append(vb.calls)
            answers = calls
    finally:
        tm._mesh_batch = real
    return out


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b",
                                  "llama4-scout-17b-a16e"])
def test_moe_positions_across_ranks_match_the_whole_batch(arch):
    jcfg = jax_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init_moe(jax.random.PRNGKey(3), jcfg))
    p = tree_from_numpy(params)
    n_ranks, group = 3, 16
    x = RNG.normal(size=(6, 10, cfg.d_model)).astype(np.float32)
    xt = torch.from_numpy(x)
    # the whole batch: 60 tokens in groups of 16, 4 of padding; the rank
    # boundaries at tokens 20 and 40 fall inside groups
    want = jm._moe_einsum(jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                          jnp.asarray(x), group=group)
    whole = tm._route_tokens(p, cfg, xt, group)
    assert float(want.dropped_frac) > 0
    ranks = _virtual_moe(p, cfg, xt, n_ranks, group)
    k = cfg.top_k
    flat = lambda t: t.reshape(-1, k)
    got_pos, got_keep, got_y = [], [], []
    for r, (routes, o) in enumerate(ranks):
        n = 20 + (4 if r == n_ranks - 1 else 0)
        got_pos.append(flat(routes.pos)[routes.lead:routes.lead + n])
        got_keep.append(flat(routes.keep)[routes.lead:routes.lead + n])
        got_y.append(o.y)
        np.testing.assert_allclose(float(o.aux_loss), float(want.aux_loss),
                                   rtol=2e-5)
        np.testing.assert_allclose(float(o.dropped_frac),
                                   float(want.dropped_frac), atol=1e-6)
    np.testing.assert_array_equal(torch.cat(got_pos).numpy(),
                                  flat(whole.pos).numpy())
    np.testing.assert_array_equal(torch.cat(got_keep).numpy(),
                                  flat(whole.keep).numpy())
    np.testing.assert_allclose(torch.cat(got_y).numpy(),
                               np.asarray(want.y), rtol=2e-5, atol=2e-5)


# --------------------------------------------------------- layouts
def _layout(spec, shape, sizes, coord):
    full = {"pod": 1, "data": 1, "model": 1}
    return TensorLayout(P(spec), shape, {**full, **sizes},
                        {**{a: 0 for a in full}, **coord})


def test_tensor_layout_shapes_and_regions():
    sizes = {"pod": 2, "data": 2, "model": 2}
    lay = _layout((("pod", "data"), "model"), (8, 6), sizes,
                  {"pod": 1, "data": 0, "model": 1})
    assert lay.local_shape == (2, 3) and lay.n_shards == 8
    assert lay.fsdp_axes() == ("pod", "data")
    assert lay.region_shape() == (4, 3)      # pod whole on the data dim
    whole = torch.arange(48.).reshape(8, 6)
    # the gathered tensor is the shard made whole on the data dim
    gathered = whole[:, 3:]
    regions = lay.regions(gathered)
    # data rank 0's region: rows [0, 2) of each pod's block of 4
    torch.testing.assert_close(regions[0], gathered[[0, 1, 4, 5]])
    # and pod 1's shard of it is the rank's own shard
    torch.testing.assert_close(lay.shard_of_region(regions[0]),
                               lay.shard(whole))
    inner = _layout((None, "model", ("pod", "data")), (3, 4, 8), sizes,
                    {"pod": 0, "data": 1, "model": 0}).inner()
    assert inner.shape == (4, 8) and inner.data_dim == 1
    assert inner.model_dim == 0 and inner.region_shape() == (2, 4)


def test_unit_split():
    assert unit_split(32, 64, 16)             # two heads of four
    assert not unit_split(8, 32, 16)          # kimi-k2's wk at 4 ranks
    assert not unit_split(64, 64, 16)         # not split
    assert unit_split(3, 96, 1)               # d_ff columns


# ------------------------------------------- collectives on one rank
@pytest.fixture
def world1(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_megatron_pair_and_fsdp_gather_on_one_rank(world1):
    g = world1
    x = torch.randn(3, 4, requires_grad=True)
    y = D.reduce_from_region(D.copy_to_region(x, g) * 2, g)
    y = D.gather_from_region(y, -1, g)
    y.sum().backward()
    torch.testing.assert_close(x.grad, torch.full((3, 4), 2.))
    sink = []
    w = torch.randn(4, 6, requires_grad=True)
    whole = D.fsdp_gather(w, 0, [g, g], 1, sink.append)
    torch.testing.assert_close(whole, w.detach())
    (whole * 3).sum().backward()
    assert w.grad is None and len(sink) == 1
    torch.testing.assert_close(sink[0], torch.full((4, 6), 3.))
    s = D.scale_grad(x, 0.5)
    x.grad = None
    s.sum().backward()
    torch.testing.assert_close(x.grad, torch.full((3, 4), 0.5))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "zamba2-1.2b"])
def test_one_rank_step_through_the_sharded_path(arch, world1, monkeypatch):
    """With every leaf that has a data dimension counted as split over
    the FSDP axes, a (1, 1, 1) mesh step takes the sharded path (each
    layer gathers its ``LeafRef``s inside its checkpointed function, the
    regions reach the sink, the step updates the shards in place) and
    trains as the one-device step: losses within 1e-5 relative, params
    within 1e-5 in the relative L2 norm of the whole tree."""
    from repro_torch._tree import tree_leaves
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sharding
    from repro_torch.train import Trainer, TrainConfig
    tc = TrainConfig(arch=get_config(arch, reduced=True), global_batch=4,
                     seq_len=16, steps=2, warmup_steps=1, log_every=1,
                     seed=3)
    plain = Trainer(tc, device="cpu")
    want = np.array([l for _, l in plain.train()["history"]])
    gathers = []
    real = sharding.D.fsdp_gather
    monkeypatch.setattr(sharding.TensorLayout, "fsdp_axes", lambda self: (
        ("data",) if self.data_dim is not None else ()))
    monkeypatch.setattr(sharding.D, "fsdp_gather",
                        lambda *a: gathers.append(1) or real(*a))
    t = Trainer(tc, device="cpu", mesh=make_host_mesh(
        (1, 1, 1), ("pod", "data", "model")))
    got = np.array([l for _, l in t.train()["history"]])
    assert gathers and t._mesh_step.run.regions == {}
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    sq = sq_ref = 0.0
    for a, b in zip(tree_leaves(t.params), tree_leaves(plain.params)):
        a, b = a.detach().double(), b.detach().double()
        sq += float(torch.sum((a - b) ** 2))
        sq_ref += float(torch.sum(b ** 2))
    assert sq <= 1e-10 * sq_ref


def test_region_collectives_take_a_strided_gradient(world1):
    """NCCL takes contiguous tensors only: a strided gradient entering
    ``copy_to_region``'s backward all-reduce is copied contiguous first."""
    g = world1
    w = torch.randn(4, 6, requires_grad=True)
    seen = []
    real = dist.all_reduce

    def spy(t, *a, **kw):
        seen.append(t.is_contiguous())
        return real(t, *a, **kw)
    dist.all_reduce = spy
    try:
        y = D.copy_to_region(w, g).t()          # a strided gradient
        (y * torch.arange(4.)).sum().backward()
    finally:
        dist.all_reduce = real
    assert seen == [True]
    torch.testing.assert_close(w.grad, torch.arange(4.)[:, None].expand(4, 6))

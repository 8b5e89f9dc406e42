"""Pipeline parallelism: pipelined BSP supersteps over a process group.

The port of ``repro.train.pipeline``.  The paper's §4.1 pipelining (feed
batch i into the DAG at round i so every level works on one batch a
round) is a GPipe schedule: the layers are cut into S stages, rank s of
the group holds stage s, microbatches enter stage 0 one a step, and
activations hand off stage to stage with a ring permute.  After
S + n_micro - 1 steps every microbatch has crossed every stage, the
L + K - 1 rounds of Theorem 4.1's query pipeline.

Every rank runs the same step loop (SPMD, as the JAX body inside
``shard_map``): stage 0 takes microbatch t where the others take the
activation handed over last step, the last stage records its result, and
a masked SUM all-reduce replicates the outputs to every rank.  Autograd
differentiates through the whole schedule (GPipe's synchronous
semantics): the hand-off's backward sends each gradient to the previous
rank, and the outputs are one replicated value, so each rank's loss on
them is the same loss and the gradient entering the last stage is its
own rank's, not a sum of S copies.  Every rank must call ``backward``.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from .._tree import tree_map
from ..core import distributed as D


def _ring(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Send ``x`` to group rank r + shift, receive from r - shift."""
    return D.permute(x, group, shift)


class _RingPermute(torch.autograd.Function):
    """``lax.ppermute`` with pairs (i, i + 1 mod S); the backward sends
    each gradient back to the rank the value came from."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _ring(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _ring(grad, ctx.group, -1), None


class _Replicate(torch.autograd.Function):
    """A masked SUM that replicates one rank's value: the result is one
    value held by every rank, so its gradient stays where it is."""

    @staticmethod
    def forward(ctx, x, group):
        return D.all_reduce_(x.clone(), group=group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def ring_permute(x: torch.Tensor, group=None) -> torch.Tensor:
    """Rank r's ``x`` to rank r + 1 of ``group`` (the last to rank 0),
    differentiably; the identity on a group of one."""
    if dist.get_world_size(group) == 1:
        return x
    return _RingPermute.apply(x, group)


def pipeline_body(stage_fn: Callable, group=None):
    """``fn(stage_params, microbatches) -> outputs`` to run on every rank
    of ``group``.  ``stage_params``: this rank's stage; ``microbatches``
    (n_micro, mb, ...), the same on every rank (stage 0 consumes them);
    the outputs (n_micro, mb, ...) of the last stage, on every rank."""

    group = dist.group.WORLD if group is None else group

    def fn(stage_params, microbatches):
        n_stages = dist.get_world_size(group)
        stage = dist.get_rank(group)
        n_micro = microbatches.shape[0]
        first = torch.tensor(stage == 0, device=microbatches.device)
        buf = torch.zeros_like(microbatches[0])
        outs = [torch.zeros_like(microbatches[0])] * n_micro
        for t in range(n_micro + n_stages - 1):
            # stage 0 ingests microbatch t; the others use the activation
            # handed over last step (a where, so every rank's graph reads
            # the hand-off and every rank meets its backward)
            x_in = torch.where(first, microbatches[min(t, n_micro - 1)], buf)
            y = stage_fn(stage_params, x_in)
            # the last stage records microbatch t - S + 1
            i = min(max(t - (n_stages - 1), 0), n_micro - 1)
            take = stage == n_stages - 1 and t >= n_stages - 1
            outs[i] = torch.where(torch.tensor(take, device=y.device), y,
                                  outs[i])
            buf = ring_permute(y, group)
        out = torch.stack(outs)
        if n_stages == 1:
            return out
        mask = float(stage == n_stages - 1)
        return _Replicate.apply(out * mask, group)

    return fn


def run_pipeline(stage_fn: Callable, stacked_params: Any,
                 microbatches: torch.Tensor, group=None) -> torch.Tensor:
    """Drive the schedule on every rank of ``group``: ``stacked_params``
    leaves have a leading dim of n_stages (rank s takes [s]);
    ``microbatches`` (n_micro, mb, ...).  Returns the (n_micro, mb, ...)
    outputs after all stages, on every rank."""
    stage = dist.get_rank(group)
    local = tree_map(lambda x: x[stage], stacked_params)
    return pipeline_body(stage_fn, group)(local, microbatches)

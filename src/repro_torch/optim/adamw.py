"""AdamW, as ``repro.optim.adamw``: global-norm clipping of the gradients,
bias-corrected moments in float32, eps outside the square root, decoupled
weight decay.  Not ``torch.optim.AdamW``, whose update clips nowhere and
orders its operations differently.

``adamw_update`` writes the new parameters and moments into the given
tensors (a step of a 1.2 B-parameter model would otherwise hold two more
copies of each) and returns them with the new step count."""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from .._tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32, on the params' device
    m: Any                   # float32 nest like the params
    v: Any


def adamw_init(params) -> AdamWState:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 grad_clip: float = 1.0, gnorm=None
                 ) -> Tuple[Any, AdamWState]:
    """One step: ``params`` and ``state``'s moments updated in place;
    returns (params, the state with step + 1).  ``lr`` is a float or a 0-d
    tensor (the schedule's, on the device).  ``gnorm``, when given, is the
    global norm to clip by: a ZeRO rank updates shards of the parameters
    and passes the norm of the whole gradient."""
    step = state.step + 1
    g_leaves = tree_leaves(grads)
    if gnorm is None:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in g_leaves))
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    stepf = step.float()
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    for p, g, m, v in zip(tree_leaves(params), g_leaves,
                          tree_leaves(state.m), tree_leaves(state.v)):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
        delta.add_(weight_decay * p.float())
        if p.dtype == torch.float32:
            p.sub_(lr * delta)
        else:
            p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, AdamWState(step=step, m=state.m, v=state.v)

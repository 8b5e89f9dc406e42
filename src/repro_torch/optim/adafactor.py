"""Adafactor (factored second moments, beta1 = 0), as
``repro.optim.adafactor``: the statistics of a parameter of two or more
dimensions are the row and column means of its trailing 2-D block, so its
state is O(rows + cols); a 1-D parameter keeps a full second moment.

``adafactor_update`` writes the new parameters and statistics into the
given tensors and returns them with the new step count."""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from .._tree import tree_leaves, tree_map


class AdafactorState(NamedTuple):
    step: torch.Tensor       # () int32
    vr: Any                  # row stats (shape minus the last dim); 1-D: v
    vc: Any                  # col stats (shape minus the second-to-last)


def _factored(p) -> bool:
    return p.ndim >= 2


def adafactor_init(params) -> AdafactorState:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"

    def vr(p):
        shape = p.shape[:-1] if _factored(p) else p.shape
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def vc(p):
        shape = (p.shape[:-2] + p.shape[-1:]) if _factored(p) else (1,)
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    return AdafactorState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        vr=tree_map(vr, params), vc=tree_map(vc, params))


@torch.no_grad()
def adafactor_update(grads, state: AdafactorState, params, lr,
                     decay: float = 0.99, eps: float = 1e-30,
                     clip_threshold: float = 1.0,
                     weight_decay: float = 0.0, reduce=None
                     ) -> Tuple[Any, AdafactorState]:
    """One step, ``params`` and the statistics updated in place; returns
    (params, the state with step + 1).

    ``reduce``, when given, makes each mean one over a parameter split
    across ranks (a ZeRO rank updates shards): ``reduce(t, i, dims)`` is
    the SUM of the partial sums ``t`` over the ranks that split dims
    ``dims`` of leaf ``i``, and ``reduce.shapes[i]`` the leaf's whole
    shape."""
    for i, (p, g, vr, vc) in enumerate(zip(
            tree_leaves(params), tree_leaves(grads), tree_leaves(state.vr),
            tree_leaves(state.vc))):
        def mean(t, dims, keepdim=False):
            # ``dims`` index ``t`` and name the parameter's dims they stand
            # for: at each use below the two coincide
            if reduce is None:
                if len(dims) == t.ndim and not keepdim:
                    return torch.mean(t)
                return torch.mean(t, dim=dims, keepdim=keepdim)
            n = 1
            for d in dims:
                n *= reduce.shapes[i][d]
            return reduce(torch.sum(t, dim=dims, keepdim=keepdim), i,
                          dims) / n

        g = g.float()
        g2 = g * g + eps
        nd = p.ndim
        if _factored(p):
            vr.copy_(decay * vr + (1 - decay) * mean(g2, (nd - 1,)))
            vc.copy_(decay * vc + (1 - decay) * mean(g2, (nd - 2,)))
            row_mean = torch.clamp(mean(vr, (nd - 2,), keepdim=True),
                                   min=eps)
            r = vr / row_mean
            # u = g / sqrt(vr * vc / mean(vr)) over the trailing 2-D block
            u = g / torch.sqrt(torch.clamp(r[..., None], min=eps))
            u = (u / torch.sqrt(torch.clamp(vc[..., None, :], min=eps))
                 * torch.sqrt(row_mean)[..., None])
        else:
            vr.copy_(decay * vr + (1 - decay) * g2)
            u = g / torch.sqrt(torch.clamp(vr, min=eps))
        # update clipping: RMS(u) <= clip_threshold
        rms = torch.sqrt(mean(u * u, tuple(range(nd))) + 1e-12)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        p.copy_((p.float() * (1 - lr * weight_decay) - lr * u).to(p.dtype))
    return params, AdafactorState(step=state.step + 1, vr=state.vr,
                                  vc=state.vc)

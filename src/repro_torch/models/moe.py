"""Mixture-of-Experts FFN: the paper's machinery as a first-class layer.

The port of ``repro.models.moe``.  MoE dispatch is the MapReduce shuffle:
tokens are items keyed by expert id, experts are reducers with bounded I/O
(capacity is the paper's M), routing is the Shuffle step and the combine a
Sum-semigroup funnel.

Two dispatches, as in the JAX package:

  'einsum'  -- tokens in groups of ``min(512, tokens)`` (the paper's
     nodes); each (token, choice)'s position in its expert is an exclusive
     prefix sum over the group's flattened (token, choice) axis (Lemma
     2.2); dispatch and combine are one-hot contractions.  Capacity a
     (group, expert) is ``ceil(group k / E cf)``; a choice past it is
     dropped and its token falls through the residual.

  'shuffle' -- the (token, choice) pairs go with
     :func:`repro_torch.core.distributed.shuffle_alltoall` to the rank of
     the expert group (:func:`repro_torch.models.sharding.use_expert_group`)
     that owns the expert; the receiver orders arrivals by local expert (a
     stable argsort, the §4.3 sort step), runs the grouped FFN (the reducer
     f), and the inverse ``all_to_all`` and a weighted sum onto the source
     tokens are the funnel combine.  Without an expert group it is the
     einsum dispatch.

On a mesh (a mesh step's :class:`~repro_torch.models.sharding.ShardRun`)
the layer is the JAX ``Trainer(mesh)``'s over the global batch: the
router's f_e and p_e are means over every ``("pod", "data")`` rank's
tokens (an all-reduce, with a gradient to p_e); the einsum dispatch's
groups of ``min(512, global tokens)`` run over the global token order,
each choice's position in its expert the rank's exclusive prefix sum
plus the lower ranks' counts of the group (Lemma 2.2 across ranks), and
``dropped_frac`` is the global mean.  Over ``"model"`` the einsum
dispatch runs the rank's experts and sums over the axis; the shuffle
dispatch runs over the ``"model"`` group with the rank's experts
gathered over the FSDP axes (as JAX all-gathers them over ``"data"``):
every ``"model"`` rank sends its copy of its tokens, and, as JAX's
``shard_map`` transpose does, the copies' gradients are averaged.  The
shared expert is tensor-parallel as an MLP.  With the sequence split
over ``"model"`` (sequence parallelism) the router runs on the rank's
slice, f_e and p_e summed over the slices, and the routes and tokens are
gathered, so the capacity groups are the global batch's as before; the
layer leaves to the slice (a reduce-scatter of the rank's experts'
parts; the shuffle dispatch keeps its slice of every token's output).

Router: softmax and top-k with renormalisation, and the load-balancing
auxiliary loss.  Top-k breaks ties explicitly, lower expert id first, as
``lax.top_k`` returns them: a zero token (the einsum path's padding) has
all-equal probabilities, and its routes enter ``dropped_frac`` and the
auxiliary loss.  The JAX package's sharding constraints are identities on
one device and are left out.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..core import distributed as D
from ..core.distributed import (all_reduce, all_to_all, scale_grad,
                                shuffle_alltoall)
from . import sharding
from .layers import Params, _dense_init, cdtype, pdtype


class MoEOut(NamedTuple):
    y: torch.Tensor             # (b, s, d) compute dtype
    aux_loss: torch.Tensor      # 0-d float32
    dropped_frac: torch.Tensor  # 0-d float32: choices past capacity


def init_moe(gen: torch.Generator, cfg: ArchConfig, lead=()) -> Params:
    """The MoE params of the JAX ``init_moe``: the router (d, E) float32
    drawn N(0, 1) * 0.02, the experts' (E, d, f) / (E, f, d) projections
    and the shared expert's in the param dtype, N(0, 1) / sqrt(fan_in)
    with the fan-in the first axis, E for the experts, as the JAX
    ``_dense_init`` takes it.  ``lead`` prepends stacked-layer axes."""
    d, f, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts
    pd = pdtype(cfg)
    p = {"router": _dense_init(gen, (d, e), torch.float32, scale=0.02,
                               lead=lead),
         "w_gate": _dense_init(gen, (e, d, f), pd, lead=lead),
         "w_up": _dense_init(gen, (e, d, f), pd, lead=lead),
         "w_down": _dense_init(gen, (e, f, d), pd, lead=lead)}
    if cfg.shared_expert:
        p["shared"] = {"w_gate": _dense_init(gen, (d, f), pd, lead=lead),
                       "w_up": _dense_init(gen, (d, f), pd, lead=lead),
                       "w_down": _dense_init(gen, (f, d), pd, lead=lead)}
    return p


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the k largest, largest first, equal
    values in ascending index order (a stable descending sort)."""
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], ids[..., :k].to(torch.int32)


def _one_hot(ids: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: all zeros for an id outside [0, n)."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(dtype)


def _route(p: Params, cfg: ArchConfig, x: torch.Tensor):
    """x (..., d) -> (top-k ids int32, renormalised weights in the compute
    dtype, the router's float32 probabilities)."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    w, ids = _top_k(probs, cfg.top_k)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return ids, w.to(cdtype(cfg)), probs


def _router(p: Params, cfg: ArchConfig, x: torch.Tensor, batch=None,
            n_total: int = 0):
    """x (..., d) -> (top-k ids int32, renormalised weights in the compute
    dtype, the load-balancing loss E sum_e f_e p_e / k).  With ``batch``
    (a mesh step's batch ranks) f_e and p_e are the means over the
    ``n_total`` tokens of every batch rank."""
    ids, w, probs = _route(p, cfg, x)
    e, k = cfg.n_experts, cfg.top_k
    if batch is None:
        f_e = _one_hot(ids, e, torch.float32).reshape(-1, k, e).mean(0).sum(0)
        p_e = probs.reshape(-1, e).mean(0)
    else:
        f_e = batch.sum(_one_hot(ids, e, torch.float32).reshape(
            -1, k, e).sum(0)).sum(0) / n_total
        p_e = batch.sum(probs.reshape(-1, e).sum(0)) / n_total
    aux = e * torch.sum(f_e * p_e) / k
    return ids, w, aux


def _route_slice(p: Params, cfg: ArchConfig, x: torch.Tensor, seq, batch,
                 n_total: int, pad: int):
    """The router on the rank's slice of a split sequence x (b, s / m,
    d): (every token's ids and weights (b s [+ pad], k), gathered over
    ``seq``, the ``"model"`` axis, in the rank's token order, the zero
    tokens of ``pad`` after them; the load-balancing loss over the
    ``n_total`` tokens of every rank).  f_e and p_e are summed over the
    slices (each rank's probabilities get the gradient of its own
    tokens) and the batch ranks; the ``pad`` zero tokens (the einsum
    path's padding, on the last batch rank) enter them once."""
    e, k = cfg.n_experts, cfg.top_k
    ids, w, probs = _route(p, cfg, x)
    f = seq.sum(_one_hot(ids, e, torch.float32).reshape(-1, k, e).sum(0))
    pe = seq.sum(probs.reshape(-1, e).sum(0))
    if batch is not None:
        f, pe = batch.sum(f), batch.sum(pe)
    ids = D.enter_sequence(ids, seq.group).reshape(-1, k)
    w = seq.enter(w).reshape(-1, k)
    if pad:
        zi, zw, zp = _route(p, cfg, x.new_zeros((pad, x.shape[-1])))
        f = f + _one_hot(zi, e, torch.float32).sum(0)
        pe = pe + zp.sum(0)
        if batch is None or batch.index == batch.size - 1:
            ids, w = torch.cat([ids, zi]), torch.cat([w, zw])
    aux = e * torch.sum(f.sum(0) / n_total * (pe / n_total)) / k
    return ids, w, aux


def _mesh_batch():
    """The active mesh step's batch ranks when they are more than one,
    else None."""
    run = sharding.shard_run()
    return run.batch if run is not None and run.batch.size > 1 else None


def _expert_ffn(p: Params, cfg: ArchConfig, xe: torch.Tensor,
                experts: slice = slice(None)) -> torch.Tensor:
    """xe (..., e, c, d) grouped by expert -> the same shape: each expert's
    SwiGLU FFN, the experts ``experts`` of the params."""
    dt = cdtype(cfg)
    gate = torch.einsum("...ecd,edf->...ecf", xe, p["w_gate"][experts].to(dt))
    up = torch.einsum("...ecd,edf->...ecf", xe, p["w_up"][experts].to(dt))
    return torch.einsum("...ecf,efd->...ecd", F.silu(gate) * up,
                        p["w_down"][experts].to(dt))


def _add_shared(p: Params, cfg: ArchConfig, x: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
    """``y`` plus the shared expert's output: over a ``"model"`` axis on
    the rank's d_ff columns, summed over the axis (with the sequence
    split, ``x`` and ``y`` the rank's slice)."""
    if not cfg.shared_expert:
        return y
    dt, sp = cdtype(cfg), p["shared"]
    tp = sharding.tp_split(sp["w_down"], 0)
    if tp is not None:
        x = tp.enter(x)
    h = F.silu(x @ sp["w_gate"].to(dt)) * (x @ sp["w_up"].to(dt))
    out = h @ sp["w_down"].to(dt)
    return y + (out if tp is None else tp.leave(out))


# ----------------------------------------------------------- einsum path
class Routes(NamedTuple):
    """The einsum dispatch's routing of x (b, s, d) in groups: on a mesh,
    the groups of the global token order that hold this rank's tokens,
    with zero slots for the other ranks' tokens."""
    xg: torch.Tensor     # (g, group, d) the tokens, zero-padded
    ids: torch.Tensor    # (g, group, k) int32 expert of each choice
    w: torch.Tensor      # (g, group, k) its weight, compute dtype
    pos: torch.Tensor    # (g, group, k) int32 position in its expert
    keep: torch.Tensor   # (g, group, k) pos < cap
    cap: int             # capacity a (group, expert)
    aux: torch.Tensor    # 0-d float32
    dropped: torch.Tensor  # 0-d float32: the choices past capacity
    lead: int = 0        # slots of xg before this rank's first token


def _route_tokens(p: Params, cfg: ArchConfig, x: torch.Tensor,
                  group: int = 512, batch=None, seq=None) -> Routes:
    """Routes of x's tokens in groups of ``min(group, tokens)``, the last
    one zero-padded.  With ``batch`` (a mesh step's batch ranks) the
    tokens are every batch rank's in row order (the padding on the last
    rank), and each choice's position adds the lower ranks' counts of its
    group and expert to the rank's own exclusive prefix sum.  With
    ``seq`` (the ``"model"`` axis of a split sequence) x is the rank's
    slice, routed there (:func:`_route_slice`), and the routes are its
    rows' whole sequences' (the tokens gathered)."""
    d = x.shape[-1]
    e, k = cfg.n_experts, cfg.top_k
    tokens = (x if seq is None else seq.enter(x)).reshape(-1, d)
    n, r = (1, 0) if batch is None else (batch.size, batch.index)
    t_l = tokens.shape[0]
    t_total = t_l * n
    group = min(group, t_total)
    pad = -t_total % group
    if pad and r == n - 1:
        tokens = F.pad(tokens, (0, 0, 0, pad))
    cap = max(1, math.ceil(group * k / e * cfg.capacity_factor))
    if seq is not None:
        ids, w, aux = _route_slice(p, cfg, x, seq, batch, t_total + pad, pad)
    if batch is None:
        xg = tokens.reshape(-1, group, d)
        if seq is None:
            ids, w, aux = _router(p, cfg, xg)
        else:
            ids, w = ids.reshape(-1, group, k), w.reshape(-1, group, k)
        lead = 0
    else:
        if seq is None:
            ids, w, aux = _router(p, cfg, tokens, batch, t_total + pad)
        start = r * t_l
        lead, tail = start % group, -(start + tokens.shape[0]) % group
        fill = lambda t, v: torch.cat([t.new_full((lead, t.shape[1]), v), t,
                                       t.new_full((tail, t.shape[1]), v)])
        xg = fill(tokens, 0).reshape(-1, group, d)
        ids = fill(ids, e).reshape(-1, group, k)       # no expert
        w = fill(w, 0).reshape(-1, group, k)
    g = xg.shape[0]
    # position of each (token, choice) within its expert: an exclusive
    # prefix sum over the group's flattened (token, choice) axis
    flat = _one_hot(ids, e, torch.int32).reshape(g, group * k, e)
    pos = torch.cumsum(flat, dim=1, dtype=torch.int32) - flat
    if batch is not None:
        # ... plus the group's choices of each expert on the lower ranks
        g0 = r * t_l // group
        counts = flat.new_zeros(((t_total + pad) // group, e))
        counts[g0:g0 + g] = flat.sum(1, dtype=torch.int32)
        below = batch.gather(counts)[:r].sum(0, dtype=torch.int32)
        pos = pos + below[g0:g0 + g, None, :]
    pos = (pos * flat).sum(-1, dtype=torch.int32).reshape(g, group, k)
    keep = pos < cap
    if batch is None:
        dropped = _dropped(keep)
    else:
        keep = keep & (ids < e)
        kept = batch.sum(keep.sum(dtype=torch.float32))
        dropped = 1.0 - kept / ((t_total + pad) * k)
    return Routes(xg=xg, ids=ids, w=w, pos=pos, keep=keep, cap=cap,
                  aux=aux, dropped=dropped, lead=lead)


def _dropped(keep: torch.Tensor) -> torch.Tensor:
    # the mean as XLA takes it: the sum times the float32 reciprocal of
    # the count, so that the fraction equals the JAX package's bit for bit
    inv = torch.tensor(1.0 / keep.numel(), dtype=torch.float32,
                       device=keep.device)
    return 1.0 - keep.sum(dtype=torch.float32) * inv


def _moe_einsum(p: Params, cfg: ArchConfig, x: torch.Tensor,
                group: int = 512) -> MoEOut:
    """x (b, s, d): tokens in groups of ``group``, capacity a (group,
    expert) ``ceil(group k / E cf)``; on a mesh over the global batch, and
    over ``"model"`` on the rank's experts, summed over the axis."""
    seq = sharding.seq_split()
    b, s, d = x.shape
    dt = cdtype(cfg)
    r = _route_tokens(p, cfg, x, group, batch=_mesh_batch(), seq=seq)
    if seq is not None:
        s = s * seq.size                     # the rows' whole sequences
    onehot = _one_hot(r.ids, cfg.n_experts, dt)                  # (g,t,k,e)
    pos_oh = _one_hot(torch.where(r.keep, r.pos, r.cap), r.cap, dt)
    xg, w = r.xg.to(dt), torch.where(r.keep, r.w, 0).to(dt)
    n_loc = p["w_gate"].shape[0]
    tp = sharding.tp_split(p["w_gate"], 0)
    if tp is not None:
        onehot = tp.block(onehot, -1, n_loc)
        xg, w = tp.copy(xg), tp.copy(w)
    # dispatch (g, t, e, c), contracted at once; then the experts
    disp = torch.einsum("gtke,gtkc->gtec", onehot, pos_oh)
    xe = torch.einsum("gtd,gtec->gecd", xg, disp)
    ye = _expert_ffn(p, cfg, xe)                                 # (g,e,c,d)
    # weight each choice, then combine back to tokens (the funnel);
    # contracting k first keeps the 5-D (g, t, k, e, c) never built
    oh_w = onehot * w[..., None]
    comb = torch.einsum("gtke,gtkc->gtec", oh_w, pos_oh)
    y = torch.einsum("gecd,gtec->gtd", ye, comb)
    if tp is not None and seq is None:
        y = tp.sum(y)
    y = y.reshape(-1, d)[r.lead:r.lead + b * s].reshape(b, s, d)
    if seq is not None:
        # the rank's experts' parts summed over the slices, or every
        # expert's output cut to the slice
        y = seq.leave(y) if tp is not None else seq.own(y)
    return MoEOut(y=_add_shared(p, cfg, x, y), aux_loss=r.aux,
                  dropped_frac=r.dropped)


# ---------------------------------------------------------- shuffle path
def _moe_shuffle(p: Params, cfg: ArchConfig, x: torch.Tensor) -> MoEOut:
    """The dispatch over the expert group (see the module docstring), on
    this rank's tokens x (b, s, d).

    Capacity a (sender, receiver) pair is ``ceil(t k / n_ep cf)`` for the
    rank's t tokens, and ``ceil(n_ep cap / e_loc cf)`` an expert on the
    receiver; ``dropped_frac`` is summed over the group (and, on a mesh,
    over the batch ranks).  Off a mesh the weights stay whole on every
    rank, which computes its own experts' slice of them; in a mesh step
    they are the rank's experts, gathered over the FSDP axes, as the JAX
    package all-gathers them over ``"data"``.  The combine puts each
    returned choice in its (token, choice) slot and sums a token's k slots,
    which adds them in a fixed order on any device."""
    group = sharding.expert_group()
    if group is None:
        return _moe_einsum(p, cfg, x)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n_ep = dist.get_world_size(group)
    if e % n_ep:
        raise ValueError(f"{e} experts do not shard over {n_ep} ranks")
    e_loc = e // n_ep
    mine = slice(dist.get_rank(group) * e_loc,
                 (dist.get_rank(group) + 1) * e_loc)
    if p["w_gate"].shape[0] == e_loc < e:
        mine = slice(None)                    # the rank's experts already
    dt = cdtype(cfg)
    dev = x.device
    batch = _mesh_batch()
    seq = sharding.seq_split()
    x_in = x
    if seq is not None:
        # routed on the slice; every "model" rank sends its rows' whole
        # sequences and keeps the output of its slice
        s = s * seq.size
        ids, w, aux = _route_slice(p, cfg, x, seq, batch, b * s * (
            batch.size if batch else 1), 0)
        x_in = seq.enter(x)
    else:
        ids, w, aux = _router(p, cfg, x, batch, b * s * (batch.size if batch
                                                          else 1))
    tp = sharding.tp()
    if tp is not None and seq is None:
        # every "model" rank sends its copy of the tokens
        x_in, w = tp.copy(x), tp.copy(w)

    t_l = b * s
    xt = x_in.to(dt).reshape(t_l, d)
    idf, wf = ids.reshape(-1), w.reshape(-1)
    n_items = t_l * k
    src_token = torch.arange(t_l, device=dev).repeat_interleave(k)
    cap = max(1, math.ceil(t_l * k / n_ep * cfg.capacity_factor))
    payload = {"x": xt[src_token], "eloc": idf % e_loc,
               "slot": torch.arange(n_items, dtype=torch.int32, device=dev)}
    out = shuffle_alltoall(idf // e_loc, payload, group, capacity=cap)
    recv_x = out.payload["x"].reshape(n_ep * cap, d)
    valid = out.valid.reshape(-1)
    recv_e = torch.where(valid, out.payload["eloc"].reshape(-1), e_loc)
    # group arrivals by local expert (the §4.3 sort step): each one's rank
    # among the arrivals for its expert
    c_loc = max(1, math.ceil(n_ep * cap / e_loc * cfg.capacity_factor))
    order = torch.argsort(recv_e, stable=True)
    sorted_e = recv_e[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.empty_like(first)
    rank[order] = torch.arange(sorted_e.shape[0], device=dev) - first
    ok = (recv_e < e_loc) & (rank < c_loc)
    # each kept arrival to its (expert, rank) cell; the others to a spill
    # row past the buffer, cut off
    cell = torch.where(ok, recv_e.long() * c_loc + rank, e_loc * c_loc)
    buf = recv_x.new_zeros((e_loc * c_loc + 1, d))
    buf[cell] = recv_x
    yb = _expert_ffn(p, cfg, buf[:-1].reshape(e_loc, c_loc, d), mine)
    # back to the arrival slots, then the inverse shuffle
    y_send = yb.reshape(-1, d)[cell.clamp(max=e_loc * c_loc - 1)]
    y_send = y_send.masked_fill(~ok[:, None], 0).reshape(n_ep, cap, d)
    back = all_to_all(y_send, group).reshape(-1, d)
    back_slot = all_to_all(out.payload["slot"], group).reshape(-1)
    back_ok = all_to_all(out.valid & ok.reshape(n_ep, cap),
                         group).reshape(-1)
    # the funnel combine: each returned choice, weighted, in its (token,
    # choice) slot; a token's k slots summed
    contrib = back * wf[back_slot.long()][:, None].to(dt)
    slots = back.new_zeros((n_items + 1, d))
    slots[torch.where(back_ok, back_slot.long(), n_items)] = contrib
    y = slots[:-1].reshape(t_l, k, d).sum(1).reshape(b, s, d)
    if seq is not None:
        y = seq.own(y)
    elif tp is not None:
        # the copies' gradients averaged (JAX's shard_map transpose)
        y = scale_grad(y, 1.0 / n_ep)
    kept = all_reduce(back_ok.sum(dtype=torch.int32), group=group)
    total = all_reduce(torch.tensor(n_items, dtype=torch.float32,
                                    device=dev), group=group)
    if batch is not None:
        kept, total = batch.sum(kept), batch.sum(total)
    dropped = 1.0 - kept.float() / total
    return MoEOut(y=_add_shared(p, cfg, x, y), aux_loss=aux,
                  dropped_frac=dropped)


def apply_moe(p: Params, cfg: ArchConfig, x: torch.Tensor) -> MoEOut:
    if cfg.moe_dispatch == "shuffle":
        return _moe_shuffle(p, cfg, x)
    return _moe_einsum(p, cfg, x)

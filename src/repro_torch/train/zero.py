"""The mesh training step: a funnel-reduced, FSDP-3 and ZeRO-sharded BSP
superstep with Megatron tensor parallelism over ``"model"``.

The port of what GSPMD does for the JAX package's ``Trainer(mesh=...)``,
written out over a ``DeviceMesh`` with dims from ``("pod", "data",
"model")``.  A rank stores only its shard of each parameter, laid out by
the parameter's spec (:func:`repro_torch.models.sharding.param_spec`,
:class:`~repro_torch.models.sharding.TensorLayout`): ``"fsdp"`` =
(``"pod"``, ``"data"``) splits one dimension, ``"model"`` another.  One
step on every rank of the mesh:

  (a) batch     rank (p, d) takes rows [(p D + d) b / (P D), ...) of the
                global batch, the split of JAX's pod-stacked reshape; the
                ``"model"`` ranks of one (p, d) share them;
  (b) forward   under a :class:`~repro_torch.models.sharding.ShardRun`,
                each layer gathers its parameters over the FSDP axes where
                it runs (inside its checkpointed function: a recompute
                gathers again) and computes Megatron style on the rank's
                heads, d_ff columns, vocabulary slice and experts, with
                the all-reduces over ``"model"``; a weight whose
                ``"model"`` split cuts a unit is gathered over ``"model"``
                for its matmul; a MoE layer takes its router statistics
                and capacity groups over the global batch;
  (c) funnel    the backward of each FSDP gather reduce-scatters the
                gradient over ``"data"``: data rank j keeps its *region*
                of the leaf (the part whose index along the ``"data"``
                axis of its spec is j); a leaf no FSDP axis splits is
                all-reduced over ``"data"``.  Then the ``"pod"`` hop on the
                region, an exact SUM (``"auto"``) or the error-feedback
                int8 mean of :func:`repro_torch.optim.compress.
                compressed_allreduce` (``"compressed"``, per-pod residuals
                on the region, the scale the MAX over ``"data"`` and
                ``"model"`` of the regions' maxima, so each region
                quantizes as JAX's whole tensor does), and the rank's
                shard of the region;
  (d) update    the optimizer updates the rank's shards in place, with
                moments laid out by :func:`repro_torch.optim.
                state_shardings`; AdamW clips by the norm of the whole
                gradient, Adafactor sums its factored means over the
                ranks that split a dimension;
  (e) loss      the mean of the ranks' losses.

With ``accum`` > 1 the rank's rows are cut into ``accum`` microbatches,
as the JAX dry run's ``build_train_step`` cuts the global batch: (b) and
the data half of (c) run once a microbatch, their regions and losses
summed in the parameter dtype, then divided by ``accum``, and the pod hop,
the update and the loss's mean run once a step.

Collectives over a group of one rank are the identity and are skipped; at
one rank the step runs the one-device step's operations.
Megatron sequence parallelism (``seq_shard_activations``) is not ported.
"""
from __future__ import annotations

import itertools
import math
from typing import Any, Dict, Optional, Tuple

import torch

from .._tree import tree_flatten, tree_leaves, tree_unflatten
from ..models import sharding as shmod
from ..models.sharding import AXES, MeshGroups, TensorLayout
from ..optim import compress
from ..optim.api import Optimizer, state_shardings


class MeshParams:
    """``model``'s parameters on ``mesh``, seen from this rank: the
    mesh's groups (``g``), the axis sizes and this rank's coordinates
    (every axis of ``AXES``), each parameter's spec (``specs``, by
    :func:`repro_torch.models.sharding.param_spec`) and layout
    (``layouts``, flat).  :meth:`keep_shards` cuts the parameters to the
    rank's shards in place."""

    def __init__(self, model, mesh):
        self.g = MeshGroups(mesh)
        self.sizes = {a: self.g.sizes.get(a, 1) for a in AXES}
        self.coord = {a: self.g.coord.get(a, 0) for a in AXES}
        params = model.trainable_tree()
        with shmod.use_mesh(mesh):
            self.specs = shmod.tree_param_specs(params)
        self.layouts = [TensorLayout(s, p.shape, self.sizes, self.coord)
                        for s, p in zip(tree_leaves(self.specs),
                                        tree_leaves(params))]

    @torch.no_grad()
    def keep_shards(self, params) -> None:
        for p, lay in zip(tree_leaves(params), self.layouts):
            if lay.n_shards > 1:
                p.data = lay.shard(p.data).clone()


class MeshStep:
    """The superstep of the module docstring for ``model`` and ``opt`` on
    ``mesh``.  ``compressed`` runs the pod hop through the int8 funnel;
    ``accum`` is the microbatches a step.  Building it keeps only this
    rank's shard of each of ``model``'s parameters (the caller's whole
    ones are cut in place)."""

    def __init__(self, model, opt: Optimizer, mesh, lr_at,
                 compressed: bool = False, accum: int = 1):
        self.model, self.opt, self.lr_at = model, opt, lr_at
        self.accum = max(1, accum)
        mp = MeshParams(model, mesh)
        self.g, self.coord, self.sizes = mp.g, mp.coord, mp.sizes
        self.n_pod, self.n_data = self.sizes["pod"], self.sizes["data"]
        self.n_model = self.sizes["model"]
        self.compressed = compressed and "pod" in self.g.names
        params = model.trainable_tree()
        self.specs, self.layouts = mp.specs, mp.layouts
        self.state_specs = state_shardings(opt, self.specs, params, mesh)
        self.state_layouts = self._state_layouts(params)
        self.n_ranks = self.g.size(self.g.names)
        self.run = shmod.ShardRun(self.g, self.layouts)
        mp.keep_shards(params)

    # -- state ---------------------------------------------------------
    def _layouts_of(self, specs, shapes) -> list:
        return [TensorLayout(s, sh, self.sizes, self.coord)
                for s, sh in zip(tree_leaves(specs), shapes)]

    def _state_layouts(self, params) -> Dict[str, list]:
        """{field name: layouts} of the optimizer state's sharded nests."""
        shapes = [tuple(p.shape) for p in tree_leaves(params)]
        if self.opt.name == "adamw":
            lay = self._layouts_of(self.state_specs.m, shapes)
            return {"m": lay, "v": lay}
        vr_shapes = [s[:-1] if len(s) >= 2 else s for s in shapes]
        vc_shapes = [s[:-2] + s[-1:] if len(s) >= 2 else (1,)
                     for s in shapes]
        return {"vr": self._layouts_of(self.state_specs.vr, vr_shapes),
                "vc": self._layouts_of(self.state_specs.vc, vc_shapes)}

    def init_ef(self, params) -> Optional[compress.EFState]:
        """Per-pod residuals on this rank's regions (compressed mode)."""
        if not self.compressed:
            return None
        leaves, struct = tree_flatten(params)
        return compress.EFState(residual=tree_unflatten(struct, [
            torch.zeros(lay.region_shape(), dtype=torch.float32,
                        device=p.device)
            for lay, p in zip(self.layouts, leaves)]))

    def gather_params(self, params):
        """The parameters as whole logical tensors (collective)."""
        leaves, struct = tree_flatten(params)
        return tree_unflatten(struct, [
            self._gathered(p.detach(), lay)
            for p, lay in zip(leaves, self.layouts)])

    def whole_like(self, params):
        """Uninitialised whole tensors of the parameters' shapes and
        dtypes (a restore's target; no collective)."""
        leaves, struct = tree_flatten(params)
        return tree_unflatten(struct, [
            p.new_empty(lay.shape) for p, lay in zip(leaves, self.layouts)])

    @torch.no_grad()
    def load_params(self, params, whole) -> None:
        """Copy this rank's shard of each whole tensor of ``whole`` into
        ``params``."""
        for p, w, lay in zip(tree_leaves(params), tree_leaves(whole),
                             self.layouts):
            p.copy_(lay.shard(w))

    def gather_state(self, state):
        """The optimizer state as whole logical tensors (collective)."""
        out = {}
        for name, lays in self.state_layouts.items():
            leaves, struct = tree_flatten(getattr(state, name))
            out[name] = tree_unflatten(struct, [
                self._gathered(x, lay) for x, lay in zip(leaves, lays)])
        return type(state)(step=state.step, **out)

    def shard_state(self, whole):
        """This rank's shards of a state of whole tensors (a restore)."""
        out = {}
        for name, lays in self.state_layouts.items():
            leaves, struct = tree_flatten(getattr(whole, name))
            out[name] = tree_unflatten(struct, [
                lay.shard(x).contiguous() for x, lay in zip(leaves, lays)])
        return type(whole)(step=whole.step, **out)

    def _gathered(self, shard: torch.Tensor,
                  lay: TensorLayout) -> torch.Tensor:
        """Every rank's shard placed into one whole tensor."""
        if lay.n_shards == 1:
            return shard
        into = shard.new_empty(lay.shape)
        parts = self.g.gather(shard)
        done = set()
        for at in itertools.product(*(range(n) for n in parts.shape[
                :len(self.g.names)])):
            coord = dict(zip(self.g.names, at))
            idx = lay.index_at({a: coord.get(a, 0) for a in AXES})
            if idx not in done:
                lay.part(into, idx).copy_(parts[at])
                done.add(idx)
        return into

    # -- the step ----------------------------------------------------------
    def local_rows(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Rank (p, d)'s rows of the global batch."""
        n = self.n_pod * self.n_data
        b = next(iter(batch.values())).shape[0]
        if b % n:
            raise ValueError(f"global batch {b} does not split over "
                             f"{n} (pod x data) ranks")
        i = self.coord["pod"] * self.n_data + self.coord["data"]
        rows = b // n
        return {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}

    def _part(self, i: int, p: torch.Tensor, g, lay: TensorLayout):
        """Leaf ``i``'s part of one microbatch's gradient on this rank:
        its region (an FSDP leaf, reduce-scattered over ``"data"`` by the
        gather's backward) or its local gradient ``g``."""
        if lay.fsdp_axes():
            r = self.run.regions.pop(i, None)
            return (torch.zeros(lay.region_shape(), dtype=p.dtype,
                                device=p.device) if r is None else r)
        return torch.zeros_like(p) if g is None else g

    def _pod_hop(self, r: torch.Tensor, lay: TensorLayout, residual):
        """(c)'s second half: the mean of the region over every batch
        rank, and the new residual (compressed)."""
        if self.compressed:
            scale = [self.g.group(a) for a, dim in (
                ("data", lay.data_dim), ("model", lay.model_dim))
                if dim is not None and self.sizes[a] > 1]
            m, residual = compress.compressed_allreduce(
                r.float() / self.n_data, residual, self.g.group("pod"),
                scale_group=scale)
            return m.to(r.dtype), residual
        self.g.all_reduce(r, ("pod",))
        n = self.n_pod * self.n_data
        return (r if n == 1 else r / n), residual

    def _reduce(self, shapes):
        """Adafactor's ``reduce`` hook: sums over the ranks that split the
        named dims of a leaf."""
        def reduce(t, i, dims):
            return self.g.all_reduce(t, {a for d in dims
                                         for a in self.layouts[i].axes[d]})
        reduce.shapes = shapes
        return reduce

    def _backward(self, rows):
        """One forward and backward of ``rows`` under the step's
        ShardRun: (the loss, each leaf's part of the gradient)."""
        leaves = tree_leaves(self.model.trainable_tree())
        self.run.regions = {}
        with shmod.use_shard_run(self.run):
            loss, _ = self.model.loss_fn(rows)
            # the gradients as the backward hands them over, without the
            # leaves' accumulators (which copy a gradient that something
            # else still holds, a count that would depend on the backend)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        parts = [self._part(i, p, g, lay) for i, (p, g, lay) in
                 enumerate(zip(leaves, grads, self.layouts))]
        return loss.detach(), parts

    def _grads(self, rows):
        """(the loss, each leaf's region of the gradient summed over
        ``"data"``): over ``accum`` microbatches of ``rows``, their sum
        in the parameter dtype over ``accum``."""
        if self.accum == 1:
            loss, parts = self._backward(rows)
        else:
            a = self.accum
            b = next(iter(rows.values())).shape[0]
            if b % a:
                raise ValueError(f"{b} rows do not split into {a} "
                                 f"microbatches")
            micro = {k: v.reshape((a, b // a) + tuple(v.shape[1:]))
                     for k, v in rows.items()}
            leaves = tree_leaves(self.model.trainable_tree())
            sums = [torch.zeros(lay.region_shape() if lay.fsdp_axes()
                                else p.shape, dtype=p.dtype,
                                device=p.device)
                    for p, lay in zip(leaves, self.layouts)]
            lsum = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for j in range(a):
                loss, parts = self._backward({k: v[j]
                                              for k, v in micro.items()})
                with torch.no_grad():
                    for acc, part in zip(sums, parts):
                        acc.add_(part.to(acc.dtype))
                del parts
                lsum = lsum + loss
            with torch.no_grad():
                parts = [g / a for g in sums]
            del sums
            loss = lsum / a
        for r, lay in zip(parts, self.layouts):
            if not lay.fsdp_axes():
                self.g.all_reduce(r, ("data",))
        return loss, parts

    def step_local(self, params, opt_state, ef_state, rows):
        """One superstep on this rank's ``rows`` of the batch
        (:meth:`local_rows`); ``params`` are the rank's shards, updated in
        place; returns (params, opt_state, ef_state, loss)."""
        leaves = tree_leaves(params)
        loss, parts = self._grads(rows)
        residuals = (tree_leaves(ef_state.residual) if ef_state is not None
                     else [None] * len(leaves))
        g_shards, new_res = [], []
        with torch.no_grad():
            for r, lay, res in zip(parts, self.layouts, residuals):
                r, res = self._pod_hop(r, lay, res)
                g_shards.append(lay.shard_of_region(r))
                new_res.append(res)
            del parts
            struct = tree_flatten(params)[1]
            grads = tree_unflatten(struct, g_shards)
            kw = {}
            if self.n_ranks == 1:
                pass                  # the one-device update
            elif self.opt.name == "adamw":
                sq = sum(torch.sum(torch.square(g.float())) * (
                    lay.n_shards / self.n_ranks)
                    for g, lay in zip(g_shards, self.layouts))
                kw["gnorm"] = torch.sqrt(self.g.all_reduce(sq, self.g.names))
            else:
                kw["reduce"] = self._reduce([lay.shape
                                             for lay in self.layouts])
            _, opt_state = self.opt.update(grads, opt_state, params,
                                           self.lr_at(opt_state.step), **kw)
            if self.n_ranks > 1:
                loss = self.g.all_reduce(loss.clone(),
                                         self.g.names) / self.n_ranks
        if ef_state is not None:
            ef_state = compress.EFState(residual=tree_unflatten(struct,
                                                                new_res))
        return params, opt_state, ef_state, loss

    def moment_bytes(self, opt_state) -> Tuple[int, int]:
        """(this rank's bytes of optimizer moments, the whole tree's)."""
        local = whole = 0
        for name, lays in self.state_layouts.items():
            for x, lay in zip(tree_leaves(getattr(opt_state, name)), lays):
                local += x.numel() * x.element_size()
                whole += math.prod(lay.shape) * x.element_size()
        return local, whole

    def param_bytes(self, params) -> Tuple[int, int]:
        """(this rank's bytes of parameters, the whole tree's)."""
        local = whole = 0
        for p, lay in zip(tree_leaves(params), self.layouts):
            local += p.numel() * p.element_size()
            whole += math.prod(lay.shape) * p.element_size()
        return local, whole

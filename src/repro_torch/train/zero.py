"""The mesh training step: a funnel-reduced, ZeRO-sharded BSP superstep.

The port of what GSPMD does for the JAX package's ``Trainer(mesh=...)``,
written out over a ``DeviceMesh`` with dims from ``("pod", "data",
"model")``.  One step on every rank of the mesh:

  (a) batch     rank (p, d) takes rows [(p D + d) b / (P D), ...) of the
                global batch, the split of JAX's pod-stacked reshape; the
                ``"model"`` ranks of one (p, d) share them;
  (b) gradient  the local loss (the mean over the rank's rows) and its
                gradients;
  (c) funnel    reduce-scatter over ``"data"``: data rank j keeps the sum
                of its *region* of each gradient, the part whose index
                along the ``"data"`` axis of the parameter's spec is j (the
                whole tensor where the spec has no ``"data"``); then the
                ``"pod"`` hop on the region, an exact SUM (``"auto"``) or
                the error-feedback int8 mean of
                :func:`repro_torch.optim.compress.compressed_allreduce`
                (``"compressed"``, per-pod residuals on the region, the
                scale the MAX over ``"data"`` of the regions' maxima, so
                each region quantizes as JAX's whole tensor does);
  (d) update    the optimizer updates only the rank's shard of each
                parameter (a view into it), with moments laid out by
                :func:`repro_torch.optim.state_shardings`; AdamW clips by
                the norm of the whole gradient, Adafactor sums its
                factored means over the ranks that split a dimension;
  (e) gather    an all-gather of the updated shards makes every
                parameter whole again on every rank;
  (f) loss      the mean of the ranks' losses.

Collectives over a group of one rank are the identity and are skipped.
Parameters stay whole on every rank (FSDP-3, gathering them layer by
layer, is not ported) and the ``"model"`` axis replicates the dense
compute (Megatron TP is not ported).  A spec shards a dimension over its
axes' product, row-major, as a ``PartitionSpec`` does.
"""
from __future__ import annotations

import itertools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from .._tree import tree_flatten, tree_leaves, tree_unflatten
from ..core.distributed import all_gather, reduce_scatter
from ..models import sharding as shmod
from ..optim import compress
from ..optim.api import Optimizer, state_shardings

AXES = ("pod", "data", "model")


def _prod(xs) -> int:
    return math.prod(xs)


class TensorLayout:
    """Where a tensor of ``shape`` with spec ``spec`` lies on a mesh of
    axis ``sizes``, seen from the rank at ``coord`` ({axis: index})."""

    def __init__(self, spec, shape, sizes: Dict[str, int],
                 coord: Dict[str, int]):
        self.shape = tuple(shape)
        self.axes = [shmod.spec_axes(e) for e in spec]
        self.sizes = sizes
        self.parts = [_prod(sizes[a] for a in ax) for ax in self.axes]
        self.index = self.index_at(coord)
        self.local_shape = tuple(n // k for n, k in zip(self.shape,
                                                        self.parts))
        self.n_shards = _prod(self.parts)
        self.data_dim = next((i for i, ax in enumerate(self.axes)
                              if "data" in ax), None)

    def index_at(self, coord: Dict[str, int]) -> Tuple[int, ...]:
        """The shard index, a dimension each, of the rank at ``coord``."""
        out = []
        for ax in self.axes:
            i = 0
            for a in ax:
                i = i * self.sizes[a] + coord[a]
            out.append(i)
        return tuple(out)

    def part(self, x: torch.Tensor, index) -> torch.Tensor:
        """The shard at ``index`` of the whole tensor ``x`` (a view)."""
        for dim, (k, i) in enumerate(zip(self.parts, index)):
            if k > 1:
                c = x.shape[dim] // k
                x = x.narrow(dim, i * c, c)
        return x

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        return self.part(x, self.index)

    # -- regions: the funnel's reduce-scatter over "data" ----------------
    def _split(self) -> Tuple[int, int, int]:
        """(sizes before, size of, sizes after) "data" on the data dim."""
        ax = self.axes[self.data_dim]
        k = ax.index("data")
        return (_prod(self.sizes[a] for a in ax[:k]), self.sizes["data"],
                _prod(self.sizes[a] for a in ax[k + 1:]))

    def regions(self, g: torch.Tensor) -> torch.Tensor:
        """(D, *region) — data rank j's region of ``g`` at [j]."""
        i = self.data_dim
        pre, d, _ = self._split()
        y = g.unflatten(i, (pre, d, g.shape[i] // (pre * d))).movedim(i + 1,
                                                                       0)
        return y.reshape((d,) + self.region_shape())

    def region_shape(self) -> Tuple[int, ...]:
        if self.data_dim is None:
            return self.shape
        shape = list(self.shape)
        shape[self.data_dim] //= self.sizes["data"]
        return tuple(shape)

    def shard_of_region(self, r: torch.Tensor,
                        coord: Dict[str, int]) -> torch.Tensor:
        """The rank's shard of its own region ``r``: the data dim is split
        over the spec's other axes there."""
        for dim, ax in enumerate(self.axes):
            rest = tuple(a for a in ax if a != "data")
            k = _prod(self.sizes[a] for a in rest)
            if k > 1:
                i = 0
                for a in rest:
                    i = i * self.sizes[a] + coord[a]
                c = r.shape[dim] // k
                r = r.narrow(dim, i * c, c)
        return r


class MeshGroups:
    """A mesh's collectives over sets of its axes, each a sequence of
    collectives over the ``DeviceMesh``'s own one-axis groups."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.names = tuple(mesh.mesh_dim_names)
        self.sizes = shmod.axis_sizes(mesh)
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not part of the mesh")
        self.coord = dict(zip(self.names, coord))
        for a in self.names:
            if dist.get_rank(self.group(a)) != self.coord[a]:
                raise ValueError(f"axis {a!r}: group ranks do not follow "
                                 f"the mesh coordinates")

    def group(self, axis: str):
        return self.mesh.get_group(axis)

    def size(self, axes) -> int:
        return _prod(self.sizes[a] for a in self.names if a in axes)

    def all_reduce(self, t: torch.Tensor, axes, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        """``t`` reduced in place over the ranks that differ only along
        ``axes``."""
        for a in self.names:
            if a in axes and self.sizes[a] > 1:
                dist.all_reduce(t, op=op, group=self.group(a))
        return t

    def barrier(self, device) -> None:
        """Wait for every rank of the mesh."""
        self.all_reduce(torch.zeros((), device=device), self.names)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every mesh rank's ``x``, stacked as (*mesh shape, *x.shape):
        the rank at coordinates c at [c]."""
        for a in reversed(self.names):
            x = (x.unsqueeze(0) if self.sizes[a] == 1 else
                 all_gather(x.contiguous().unsqueeze(0), self.group(a)))
        return x


class MeshStep:
    """The superstep of the module docstring for ``model`` and ``opt`` on
    ``mesh``.  ``compressed`` runs the pod hop through the int8 funnel."""

    def __init__(self, model, opt: Optimizer, mesh, lr_at,
                 compressed: bool = False):
        self.model, self.opt, self.lr_at = model, opt, lr_at
        self.g = MeshGroups(mesh)
        sizes = {a: self.g.sizes.get(a, 1) for a in AXES}
        self.coord = {a: self.g.coord.get(a, 0) for a in AXES}
        self.n_pod, self.n_data = sizes["pod"], sizes["data"]
        self.compressed = compressed and "pod" in self.g.names
        params = model.trainable_tree()
        with shmod.use_mesh(mesh):
            self.specs = shmod.tree_param_specs(params)
        self.state_specs = state_shardings(opt, self.specs, params, mesh)
        self.sizes = sizes
        self.layouts = [TensorLayout(s, p.shape, sizes, self.coord)
                        for s, p in zip(tree_leaves(self.specs),
                                        tree_leaves(params))]
        self.state_layouts = self._state_layouts(params)
        self.n_ranks = self.g.size(self.g.names)

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

    def init_state(self, params):
        """The optimizer state of this rank's shards: the optimizer's own
        init, on the shards."""
        return self.opt.init(self.param_shards(params))

    def param_shards(self, params):
        """Views of this rank's shard of every parameter."""
        leaves, struct = tree_flatten(params)
        return tree_unflatten(struct, [lay.shard(p.detach()) for lay, p in
                                       zip(self.layouts, leaves)])

    def init_ef(self, params) -> Optional[compress.EFState]:
        """Per-pod residuals on this rank's regions (compressed mode)."""
        if not self.compressed:
            return None
        leaves, struct = tree_flatten(params)
        return compress.EFState(residual=tree_unflatten(struct, [
            torch.zeros(lay.region_shape(), dtype=torch.float32,
                        device=p.device)
            for lay, p in zip(self.layouts, leaves)]))

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

    def _gathered(self, shard: torch.Tensor, lay: TensorLayout,
                  into: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Every rank's shard placed into one whole tensor (``into``, whose
        own shard already holds ``shard``, or a new one)."""
        if lay.n_shards == 1:
            return shard if into is None else into
        if into is None:
            into = shard.new_empty(lay.shape)
            lay.part(into, lay.index).copy_(shard)
        parts = self.g.gather(shard)
        done = {lay.index}
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

    def _funnel(self, g: torch.Tensor, lay: TensorLayout, residual):
        """(c): the rank's region of the mean gradient, and the new
        residual (compressed)."""
        if self.n_data == 1:
            r = g
        elif lay.data_dim is None:
            r = self.g.all_reduce(g, ("data",))
        else:
            r = reduce_scatter(lay.regions(g).flatten(0, 1),
                               self.g.group("data")).reshape(
                                   lay.region_shape())
        if self.compressed:
            pod = self.g.group("pod")
            data = self.g.group("data") if "data" in self.g.names else None
            r, residual = compress.compressed_allreduce(
                r.float() / self.n_data, residual, pod,
                scale_group=data if lay.data_dim is not None else None)
            return r.to(g.dtype), residual
        self.g.all_reduce(r, ("pod",))
        return r / (self.n_pod * self.n_data), residual

    def _reduce(self, shapes):
        """Adafactor's ``reduce`` hook: sums over the ranks that split the
        named dims of a leaf."""
        def reduce(t, i, dims):
            return self.g.all_reduce(t, {a for d in dims
                                         for a in self.layouts[i].axes[d]})
        reduce.shapes = shapes
        return reduce

    def step_local(self, params, opt_state, ef_state, rows):
        """One superstep on this rank's ``rows`` of the batch
        (:meth:`local_rows`); returns (params, opt_state, ef_state,
        loss)."""
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None
        loss, _ = self.model.loss_fn(rows)
        loss.backward()
        residuals = (tree_leaves(ef_state.residual) if ef_state is not None
                     else [None] * len(leaves))
        g_shards, new_res = [], []
        with torch.no_grad():
            for p, lay, res in zip(leaves, self.layouts, residuals):
                g = torch.zeros_like(p) if p.grad is None else p.grad
                r, res = self._funnel(g, lay, res)
                g_shards.append(lay.shard_of_region(r, self.coord))
                new_res.append(res)
                p.grad = None
            struct = tree_flatten(params)[1]
            grads = tree_unflatten(struct, g_shards)
            shards = self.param_shards(params)
            kw = {}
            if self.opt.name == "adamw":
                sq = sum(torch.sum(torch.square(g.float())) * (
                    lay.n_shards / self.n_ranks)
                    for g, lay in zip(g_shards, self.layouts))
                kw["gnorm"] = torch.sqrt(self.g.all_reduce(sq, self.g.names))
            else:
                kw["reduce"] = self._reduce([lay.shape
                                             for lay in self.layouts])
            _, opt_state = self.opt.update(grads, opt_state, shards,
                                           self.lr_at(opt_state.step), **kw)
            for p, s, lay in zip(leaves, tree_leaves(shards), self.layouts):
                self._gathered(s, lay, into=p.detach())
            loss = self.g.all_reduce(loss.detach().clone(),
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
                whole += _prod(lay.shape) * x.element_size()
        return local, whole

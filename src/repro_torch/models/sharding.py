"""Mesh context, parameter sharding rules and the MoE's expert group.

The port of ``repro.models.sharding``.  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose dim names come from
``("pod", "data", "model")`` (:func:`repro_torch.launch.mesh.make_host_mesh`
builds one over the world's ranks).  Logical axes:

  'batch'  -> ('pod', 'data') on a mesh with a pod axis, ('data',) else
  'fsdp'   -> the ZeRO parameter and optimizer-state axis: ('pod', 'data')
  'model'  -> the TP / EP axis (heads, d_ff, experts, vocab)

A spec (:class:`PartitionSpec`, a tuple) has one entry per dimension: a
mesh axis name, a tuple of names (the dimension split over their product,
row-major), or None.
:func:`param_spec` maps a parameter's '/'-joined path to its spec by the
first matching rule of :data:`PARAM_RULES`; :func:`validate_spec` drops an
axis whose size does not divide its dimension.  The mesh ``Trainer``
(:mod:`repro_torch.train.zero`) lays optimizer state out by these specs.

What has no counterpart: the JAX module's ``shard`` and ``tree_shardings``
are GSPMD placement hints (``with_sharding_constraint``, ``NamedSharding``)
for a compiler that partitions a global program; PyTorch runs one program
a rank and places nothing, so the port computes specs and the trainer
slices by them.

The MoE layer's expert-parallel group: where the JAX package shards
experts over the active mesh's ``"model"`` axis, the port's ``shuffle``
dispatch reads the mesh's ``"model"`` group during a mesh step, and
otherwise the process group set by :func:`use_expert_group`; without
either it runs the ``einsum`` dispatch, as the JAX package's does without
a ``"model"`` axis.

Parameters on a mesh (the mesh ``Trainer``, :mod:`repro_torch.train.zero`):
a rank stores only its shard of each parameter, laid out by its spec
(:class:`TensorLayout`).  During a step a :class:`ShardRun` is active
(:func:`use_shard_run`): the model's ``train_params`` hands out
:class:`LeafRef` s, and :func:`materialize` gathers one over the FSDP
axes (``"pod"``, ``"data"``) where its layer is computed, inside the
layer's checkpointed function, so a recompute gathers again; the
backward reduce-scatters the gradient over ``"data"`` into the rank's
region and leaves the ``"pod"`` hop to the step.  A ``"model"`` split
stays: the layers compute Megatron style on the rank's heads, d_ff
columns, vocabulary slice or experts (:func:`tp` gives the axis), and
gather over ``"model"`` only a weight whose split cuts a unit
(:func:`unit_split`: a head of ``wq``/``wk``/``wv``, ``in_proj``'s packed
[z, x, B, C, dt] block, an RWKV head).

Megatron sequence parallelism (the config's ``seq_shard_activations``,
the JAX package's ``residual_shard``): inside a :func:`sequence` block
whose length the ``"model"`` axis divides, the residual stream between
the regions is the rank's slice of the sequence
(:class:`TensorParallel`'s ``enter`` / ``leave``), and the step sums over
``"model"`` the gradients of the whole leaves a layer took there
(``ShardRun.seq_leaves``).  A length the axis does not divide stays
whole, as JAX's ``shard`` drops such an axis.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import re
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .._tree import tree_map
from ..core import distributed as D

_MESH: contextvars.ContextVar[Optional[Any]] = contextvars.ContextVar(
    "repro_torch_mesh", default=None)
_RULE_OVERRIDES: contextvars.ContextVar[Tuple[Tuple[str, Optional[Tuple]],
                                              ...]] = \
    contextvars.ContextVar("repro_torch_rule_overrides", default=())
_EXPERT_GROUP: contextvars.ContextVar[Optional[Any]] = contextvars.ContextVar(
    "repro_torch_expert_group", default=None)
_SHARD_RUN: contextvars.ContextVar[Optional["ShardRun"]] = \
    contextvars.ContextVar("repro_torch_shard_run", default=None)
#: whether the residual stream is split over "model" (:func:`sequence`)
_SEQ: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_seq_split", default=False)


class PartitionSpec(tuple):
    """A spec: one entry a dimension (an axis name, a tuple of names, or
    None).  A leaf of the nest helpers, as JAX's ``PartitionSpec`` is a
    leaf of its pytrees."""
    _tree_leaf = True

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class MeshLayout(NamedTuple):
    """A mesh's dim names and sizes without its ranks: what the spec
    functions read of a ``DeviceMesh`` (they take either), for planning a
    layout on a machine that does not have the ranks."""
    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def axis_sizes(mesh) -> dict:
    """{dim name: size} of a ``DeviceMesh`` or :class:`MeshLayout`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def set_rule_overrides(overrides) -> None:
    """Prepend (pattern, spec) pairs to the parameter rules — config-driven
    layout experiments (e.g. replicate_kv_proj)."""
    _RULE_OVERRIDES.set(tuple(overrides))


def rules_for_config(cfg) -> None:
    ov = []
    if getattr(cfg, "replicate_kv_proj", False):
        ov.append((r"(attn|attention)\w*/w[kv]$", ("fsdp", None)))
    if getattr(cfg, "replicate_attn", False):
        # archs whose head count can't use the TP axis (whisper: 8 heads on
        # a 16-wide axis): replicate attention weights, TP only the MLP
        ov.append((r"(attn|attention)\w*/w[qkvo]$", ("fsdp", None)))
    set_rule_overrides(ov)


@contextlib.contextmanager
def config_rules(cfg):
    """:func:`rules_for_config` for the block only (the JAX dry run's
    ``param_specs`` applies them)."""
    token = _RULE_OVERRIDES.set(())
    try:
        rules_for_config(cfg)
        yield
    finally:
        _RULE_OVERRIDES.reset(token)


def get_mesh():
    return _MESH.get()


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``, a :class:`MeshLayout` or None) the
    active mesh inside the block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def batch_axes() -> Tuple[str, ...]:
    mesh = get_mesh()
    if mesh is not None and "pod" in mesh.mesh_dim_names:
        return ("pod", "data")
    return ("data",)


def _resolve(axis):
    """Map a logical axis name to mesh axes (or None when unavailable)."""
    mesh = get_mesh()
    names = tuple(mesh.mesh_dim_names) if mesh is not None else ()
    if axis is None:
        return None
    if axis == "batch":
        ba = tuple(a for a in batch_axes() if a in names)
        return ba if ba else None
    if axis == "fsdp":
        # ZeRO across pods too when a 'pod' axis exists
        fa = tuple(a for a in ("pod", "data") if a in names)
        return fa if fa else None
    if isinstance(axis, (tuple, list)):
        got = tuple(a for a in axis if a in names)
        return got if got else None
    return axis if axis in names else None


def logical_spec(*axes) -> PartitionSpec:
    return P(_resolve(a) for a in axes)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, in order."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _axis_size(mesh, entry) -> int:
    sizes = axis_sizes(mesh)
    size = 1
    for a in spec_axes(entry):
        size *= sizes[a]
    return size


def validate_spec(spec, shape) -> PartitionSpec:
    """Drop spec axes whose mesh size does not divide the dimension:
    replication instead of padding keeps any arch legal (e.g. whisper's
    51865 vocab on a wide model axis).  One entry a dimension."""
    mesh = get_mesh()
    if mesh is None:
        return P(spec)
    out = []
    for i, dim in enumerate(shape):
        axis = spec[i] if i < len(spec) else None
        if axis is not None and dim % _axis_size(mesh, axis) != 0:
            axis = None
        out.append(axis)
    return P(out)


# ---------------------------------------------------------------------------
# Parameter partitioning rules (path regex -> logical spec)
# ---------------------------------------------------------------------------
# Matched against '/'-joined param paths; first match wins.  A rule's spec
# applies to the trailing dims; extra leading (stacked-layer) dims stay
# unsharded.  None: replicate.
PARAM_RULES: Sequence[Tuple[str, Optional[Tuple]]] = (
    (r"embed/table$",            ("model", "fsdp")),      # vocab-parallel
    (r"lm_head/w$",              ("fsdp", "model")),      # d_model, vocab
    (r"(attn|attention)\w*/wq$", ("fsdp", "model")),      # (D, H*dh)
    (r"(attn|attention)\w*/wk$", ("fsdp", "model")),
    (r"(attn|attention)\w*/wv$", ("fsdp", "model")),
    (r"(attn|attention)\w*/wo$", ("model", "fsdp")),      # (H*dh, D)
    (r"(attn|attention)\w*/(bq|bk|bv|bo)$", (None,)),
    (r"mlp/w_(gate|up)$",        ("fsdp", "model")),      # (D, F)
    (r"mlp/w_down$",             ("model", "fsdp")),      # (F, D)
    (r"mlp/b_\w+$",              (None,)),
    (r"moe/router$",             ("fsdp", None)),         # (D, E)
    (r"moe/w_(gate|up)$",        ("model", "fsdp", None)),  # (E, D, F)
    (r"moe/w_down$",             ("model", None, "fsdp")),  # (E, F, D)
    (r"moe/shared/w_(gate|up)$", ("fsdp", "model")),
    (r"moe/shared/w_down$",      ("model", "fsdp")),
    (r"(ssm|mamba)/in_proj$",    ("fsdp", "model")),
    (r"(ssm|mamba)/out_proj$",   ("model", "fsdp")),
    (r"(ssm|mamba)/.*$",         None),                   # small: replicate
    (r"(rwkv|time)/(receptance|key|value|gate)$", ("fsdp", "model")),
    (r"(rwkv|time)/output$",     ("model", "fsdp")),
    (r"chan/wk$",                ("fsdp", "model")),
    (r"chan/wv$",                ("model", "fsdp")),
    (r"chan/wr$",                ("fsdp", "model")),
    (r"(rwkv|time|chan)/.*$",    None),
    (r"(norm|ln)\w*/(scale|bias)$", (None,)),
    (r"pos_embed/table$",        (None, "fsdp")),
    (r".*",                      None),                   # default: replicate
)


def param_spec(path: str, shape) -> PartitionSpec:
    """The spec of a parameter, given its '/'-joined path and shape, under
    the active mesh."""
    ndim = len(shape)
    for pattern, spec in tuple(_RULE_OVERRIDES.get()) + tuple(PARAM_RULES):
        if re.search(pattern, path):
            if spec is None:
                return P((None,) * ndim)
            resolved = [_resolve(a) for a in spec][:ndim]
            pad = ndim - len(resolved)
            return validate_spec([None] * pad + resolved, shape)
    return P((None,) * ndim)


def tree_paths(tree) -> Any:
    """The nest with each leaf replaced by its '/'-joined path (dict keys
    and sequence indices; NamedTuple fields add nothing, as in the JAX
    package's ``tree_param_specs``)."""
    def walk(node, parts):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v, parts + [str(k)]) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*[walk(c, parts) for c in node])
        if isinstance(node, (list, tuple)):
            return type(node)(walk(c, parts + [str(i)])
                              for i, c in enumerate(node))
        return "/".join(parts)
    return walk(tree, [])


def tree_param_specs(params: Any) -> Any:
    """Nest of specs matching ``params`` (path-based rules)."""
    return tree_map(lambda path, leaf: param_spec(path, tuple(leaf.shape)),
                    tree_paths(params), params)


# ---------------------------------------------------------------------------
# The MoE layer's expert group
# ---------------------------------------------------------------------------

def expert_group():
    """The ``torch.distributed`` group the experts are sharded over: the
    ``"model"`` group of an active :class:`ShardRun` whose mesh has that
    axis, else the one :func:`use_expert_group` set, or None."""
    run = _SHARD_RUN.get()
    if run is not None and run.expert_group is not None:
        return run.expert_group
    return _EXPERT_GROUP.get()


@contextlib.contextmanager
def use_expert_group(group):
    """Shard the experts over ``group`` (a ``torch.distributed`` process
    group; ``torch.distributed.group.WORLD`` for the default one) inside
    the block: rank r of k computes experts [r E/k, (r+1) E/k)."""
    token = _EXPERT_GROUP.set(group)
    try:
        yield group
    finally:
        _EXPERT_GROUP.reset(token)


# ---------------------------------------------------------------------------
# Parameters on a mesh: layouts, the mesh's groups, the step's context
# ---------------------------------------------------------------------------
AXES = ("pod", "data", "model")


class TensorLayout:
    """Where a tensor of ``shape`` with spec ``spec`` lies on a mesh of
    axis ``sizes``, seen from the rank at ``coord`` ({axis: index}).

    The rank's *shard* splits each dimension over its spec entry's axes.
    Its *region* is what the FSDP gather's backward leaves it: the shard,
    but on the dimension that ``"data"`` splits only that axis's block (a
    ``"pod"`` before it in the entry stays whole there).  The *gathered*
    shape is the shard made whole on that dimension."""

    def __init__(self, spec, shape, sizes: Dict[str, int],
                 coord: Dict[str, int]):
        self.spec, self.shape = tuple(spec), tuple(shape)
        self.axes = [spec_axes(e) for e in spec]
        self.sizes, self.coord = sizes, dict(coord)
        self.parts = [math.prod(sizes[a] for a in ax) for ax in self.axes]
        self.index = self.index_at(coord)
        self.local_shape = tuple(n // k for n, k in zip(self.shape,
                                                        self.parts))
        self.n_shards = math.prod(self.parts)
        self.data_dim = next((i for i, ax in enumerate(self.axes)
                              if "data" in ax), None)
        self.model_dim = next((i for i, ax in enumerate(self.axes)
                               if "model" in ax), None)

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

    def inner(self) -> "TensorLayout":
        """The layout of one entry of a leaf stacked on axis 0 (a layer of
        ``layers``), whose spec leaves axis 0 whole."""
        return TensorLayout(self.spec[1:], self.shape[1:], self.sizes,
                            self.coord)

    # -- FSDP: the gather, the regions and the pod hop's shard ------------
    def fsdp_axes(self) -> Tuple[str, ...]:
        """The axes of more than one rank that the FSDP gather runs over
        (of the data dimension's entry), outermost first; () when they
        split nothing."""
        if self.data_dim is None:
            return ()
        return tuple(a for a in self.axes[self.data_dim]
                     if self.sizes[a] > 1)

    def region_shape(self) -> Tuple[int, ...]:
        shape = list(self.local_shape)
        if self.data_dim is not None:
            shape[self.data_dim] = (self.shape[self.data_dim]
                                    // self.sizes["data"])
        return tuple(shape)

    def regions(self, g: torch.Tensor) -> torch.Tensor:
        """(D, *region) of ``g`` in the gathered shape: data rank j's
        region at [j]."""
        i = self.data_dim
        ax = self.axes[i]
        k = ax.index("data")
        pre = math.prod(self.sizes[a] for a in ax[:k])
        d = self.sizes["data"]
        y = g.unflatten(i, (pre, d, g.shape[i] // (pre * d))).movedim(i + 1,
                                                                       0)
        return y.reshape((d,) + self.region_shape())

    def shard_of_region(self, r: torch.Tensor) -> torch.Tensor:
        """The rank's shard of its own region ``r``: the data dimension's
        other axes split it there."""
        if self.data_dim is None:
            return r
        dim = self.data_dim
        rest = tuple(a for a in self.axes[dim] if a != "data")
        k = math.prod(self.sizes[a] for a in rest)
        if k == 1:
            return r
        i = 0
        for a in rest:
            i = i * self.sizes[a] + self.coord[a]
        c = r.shape[dim] // k
        return r.narrow(dim, i * c, c)


def unit_split(local: int, whole: int, unit: int) -> bool:
    """Whether a ``"model"`` split that leaves a rank ``local`` of
    ``whole`` falls on whole units of ``unit``: then the rank computes on
    its own units, else it gathers the weight over ``"model"``."""
    return local < whole and local % unit == 0


class MeshGroups:
    """A mesh's collectives over sets of its axes, each a sequence of
    collectives over the ``DeviceMesh``'s own one-axis groups."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.names = tuple(mesh.mesh_dim_names)
        self.sizes = axis_sizes(mesh)
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
        return math.prod(self.sizes[a] for a in self.names if a in axes)

    def all_reduce(self, t: torch.Tensor, axes, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        """``t`` reduced in place over the ranks that differ only along
        ``axes``."""
        for a in self.names:
            if a in axes and self.sizes[a] > 1:
                D.all_reduce_(t, op=op, group=self.group(a))
        return t

    def barrier(self, device) -> None:
        """Wait for every rank of the mesh."""
        self.all_reduce(torch.zeros((), device=device), self.names)

    def gather(self, x: torch.Tensor, axes=None) -> torch.Tensor:
        """The ``x`` of every rank that differs from this one only along
        ``axes`` (default: all), stacked as (*their sizes, *x.shape), the
        rank at coordinates c at [c]."""
        axes = self.names if axes is None else tuple(
            a for a in self.names if a in axes)
        for a in reversed(axes):
            x = (x.unsqueeze(0) if self.sizes[a] == 1 else
                 D.all_gather(x.contiguous().unsqueeze(0), self.group(a)))
        return x


class TensorParallel:
    """The ``"model"`` axis of a mesh step, seen from this rank: the
    Megatron pair and the gathers a layer's tensor-parallel region uses
    (:mod:`repro_torch.core.distributed`).

    Inside :func:`sequence` blocks that split the sequence (``seq``,
    Megatron sequence parallelism) the residual stream between the
    regions is the rank's slice of the sequence: :meth:`enter` gathers
    it, :meth:`leave` reduce-scatters the region's output back to the
    slice, and every value a rank computes from its slice is its part of
    the objective's, so :meth:`copy` is the identity there (the mesh
    step sums the gradients of the leaves used so over ``"model"``)."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank

    @property
    def seq(self) -> bool:
        """Whether the residual stream is split over the axis here."""
        return _SEQ.get()

    def copy(self, x):
        """``x`` (replicated) as the rank's own; with the sequence split
        ``x`` already is."""
        return x if self.seq else D.copy_to_region(x, self.group)

    def sum(self, x):
        """The ranks' parts summed, replicated."""
        return D.reduce_from_region(x, self.group)

    def enter(self, x):
        """Enter the region with the residual stream ``x`` (b, s, ...):
        :meth:`copy`, or with the sequence split the ranks' slices
        gathered (reduce-scattered in the backward)."""
        if self.seq:
            return D.enter_sequence(x, self.group)
        return self.copy(x)

    def leave(self, x):
        """Leave the region: the ranks' parts summed (:meth:`sum`), or
        with the sequence split summed and cut to the rank's slice
        (all-gathered in the backward)."""
        if self.seq:
            return D.leave_sequence(x, self.group)
        return self.sum(x)

    def enter_whole(self, x):
        """``x``, whole on every rank with the whole gradient there (made
        where the sequence is not split), entered into a region of a
        split sequence: the ranks' parts of its gradient summed."""
        return D.copy_to_region(x, self.group)

    def own(self, x):
        """With the sequence split, the rank's slice of ``x`` (b, s, ...)
        that every rank computed whole; else ``x``."""
        if not self.seq:
            return x
        n = x.shape[1] // self.size
        return x.narrow(1, self.rank * n, n)

    def gather_out(self, x, dim: int):
        """Leave the region: the ranks' blocks along ``dim``, replicated."""
        return D.gather_from_region(x, dim, self.group)

    def whole(self, w, dim: int, full: int):
        """Weight ``w`` whole along ``dim`` inside the region: gathered if
        it is the rank's block, else (replicated) entered as the rank's
        own; either way the ranks' gradients are summed."""
        if w.shape[dim] < full:
            return D.gather_along(w, dim, self.group)
        return self.copy(w)

    def block(self, x, dim: int, n: int):
        """The rank's block of ``n`` along ``dim``."""
        return x.narrow(dim, self.rank * n, n)


class BatchAxes:
    """The ranks a mesh step's batch splits over (``("pod", "data")`` by
    default): rank ``index`` of ``size`` in the global batch's row
    order."""

    def __init__(self, groups: MeshGroups, axes=("pod", "data")):
        self.groups = groups
        self.axes = tuple(a for a in axes if a in groups.names)
        self.size = groups.size(self.axes)
        self.index = 0
        for a in self.axes:
            self.index = self.index * groups.sizes[a] + groups.coord[a]

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """SUM over the batch ranks (carries a gradient)."""
        for a in self.axes:
            if self.groups.sizes[a] > 1:
                x = D.all_reduce(x, group=self.groups.group(a))
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(size, *x.shape): every batch rank's ``x`` in row order."""
        return self.groups.gather(x.detach(), self.axes).reshape(
            (self.size,) + tuple(x.shape))


class LeafRef:
    """A parameter (or one layer's view of a stacked one) as a rank holds
    it on a mesh: its shard, layout, leaf index (and layer) and the dtype
    its compute casts it to.  :func:`materialize` turns it into the tensor
    a layer computes with."""

    _tree_leaf = True
    __slots__ = ("tensor", "layout", "leaf", "layer", "dtype")

    def __init__(self, tensor, layout, leaf, layer=None, dtype=None):
        self.tensor, self.layout, self.leaf = tensor, layout, leaf
        self.layer, self.dtype = layer, dtype


def _tagged(t: torch.Tensor, lay: TensorLayout, leaf: int) -> torch.Tensor:
    """``t``, a tensor a layer computes with, marked with the dimension
    its leaf's layout splits over more than one ``"model"`` rank (None:
    whole), what :func:`tp_split` reads, and with its leaf index."""
    md = lay.model_dim
    t.tp_dim = md if md is not None and lay.parts[md] > 1 else None
    t.leaf_index = leaf
    return t


class ShardRun:
    """What a mesh step's model reads while it runs (:func:`use_shard_run`):
    the leaves' layouts, the mesh's groups, the ``"model"`` axis (``tp``,
    None at one rank), the batch ranks (``batch_axes``, by default
    ``("pod", "data")``), the sink of the FSDP gathers' regions
    (``regions``: leaf index -> the rank's region of its gradient, summed
    over the step's gathers), and on a serving mesh the decode state's
    layouts (``state_layouts``: field name -> the :class:`TensorLayout` of
    the whole stacked leaf) and ``init_state()``, the rank's part of a
    zeroed state (both None in training).

    ``seq_shard`` (the config's ``seq_shard_activations``): Megatron
    sequence parallelism, the residual stream of a sequence whose length
    the ``"model"`` axis divides split over it (:func:`sequence`);
    ``seq_leaves`` collects the indices of the leaves a layer took
    (:func:`materialize`) while it was split, whose gradients are then
    the rank's parts."""

    def __init__(self, groups: MeshGroups, layouts,
                 batch_axes=("pod", "data"), seq_shard: bool = False):
        self.groups = groups
        self.layouts = list(layouts)
        m = groups.sizes.get("model", 1)
        self.tp = (TensorParallel(groups.group("model"), m,
                                  groups.coord["model"]) if m > 1 else None)
        self.seq_shard = seq_shard
        self.seq_leaves: set = set()
        self.expert_group = (groups.group("model")
                             if "model" in groups.names else None)
        self.batch = BatchAxes(groups, batch_axes)
        self.regions: Dict[int, torch.Tensor] = {}
        self.state_layouts: Optional[Dict[str, TensorLayout]] = None
        self.init_state: Optional[Callable[[], Any]] = None

    def splits(self, length: int) -> bool:
        """Whether a sequence of ``length`` positions is split over
        ``"model"``: sequence parallelism on, more than one ``"model"``
        rank, and a length the axis divides (the JAX package's rule,
        ``repro.models.sharding.shard``: an axis that does not divide
        its dimension is dropped)."""
        return (self.seq_shard and self.tp is not None
                and length % self.tp.size == 0)

    def refs(self, leaves, dtypes):
        """The flat trainable ``leaves`` as a layer takes them, each to be
        cast to its ``dtypes`` entry (None: kept): a :class:`LeafRef` where
        an FSDP axis splits the leaf (cast once gathered), else the leaf
        cast here, as on one device."""
        out = []
        for i, (p, lay, dt) in enumerate(zip(leaves, self.layouts, dtypes)):
            if lay.fsdp_axes():
                out.append(LeafRef(p, lay, i, None, dt))
            else:
                out.append(_tagged(p if dt is None else p.to(dt), lay, i))
        return out

    def layer_refs(self, ref: LeafRef):
        """Per-layer refs of a leaf stacked on axis 0 (one unbind)."""
        lay = ref.layout.inner()
        return [LeafRef(t, lay, ref.leaf, j, ref.dtype)
                for j, t in enumerate(ref.tensor.unbind(0))]

    def layer_views(self, leaf: torch.Tensor, i: int):
        """Per-layer views of flat leaf ``i`` (not a :class:`LeafRef`),
        stacked on axis 0."""
        lay = self.layouts[i].inner()
        return [_tagged(t, lay, i) for t in leaf.unbind(0)]

    def state_layout(self, name: str) -> Optional[TensorLayout]:
        """The layout of one layer's entry of the decode state's stacked
        leaf ``name`` (None off a serving mesh)."""
        if self.state_layouts is None:
            return None
        return self.state_layouts[name].inner()

    def _sink(self, ref: LeafRef) -> Callable:
        def add(region: torch.Tensor) -> None:
            acc = self.regions.get(ref.leaf)
            if acc is None:
                lay = self.layouts[ref.leaf]
                acc = self.regions[ref.leaf] = region.new_zeros(
                    lay.region_shape())
            (acc if ref.layer is None else acc[ref.layer]).add_(region)
        return add

    def materialize(self, ref: LeafRef) -> torch.Tensor:
        if _SEQ.get():
            self.seq_leaves.add(ref.leaf)
        x = ref.tensor
        axes = ref.layout.fsdp_axes()
        if axes:
            groups = [self.groups.group(a) for a in axes]
            x = D.fsdp_gather(x, ref.layout.data_dim, groups,
                              axes.index("data") if "data" in axes else None,
                              self._sink(ref))
        return _tagged(x if ref.dtype is None else x.to(ref.dtype),
                       ref.layout, ref.leaf)


def shard_run() -> Optional[ShardRun]:
    """The active :class:`ShardRun`, or None off a mesh step."""
    return _SHARD_RUN.get()


def tp() -> Optional[TensorParallel]:
    """The ``"model"`` axis of the active mesh step when it has more than
    one rank, else None (the layers then compute as on one device)."""
    run = _SHARD_RUN.get()
    return None if run is None else run.tp


def tp_split(w: torch.Tensor, dim: int) -> Optional[TensorParallel]:
    """The ``"model"`` axis (:func:`tp`) where the active mesh step gave
    this rank a block of ``w`` along ``dim``, else None: the one test by
    which a layer enters its tensor-parallel region.  ``w`` is a tensor
    the step handed the layer (a leaf as :class:`ShardRun` makes it, or
    logits marked by the LM head); the test reads the dimension its
    leaf's :class:`TensorLayout` splits over ``"model"``
    (``model_dim``), which is None where ``validate_spec`` left the
    leaf whole."""
    axis = tp()
    if axis is None:
        return None
    md = getattr(w, "tp_dim", None)
    return axis if md is not None and md == dim % w.ndim else None


@contextlib.contextmanager
def use_shard_run(run: Optional[ShardRun]):
    token = _SHARD_RUN.set(run)
    try:
        yield run
    finally:
        _SHARD_RUN.reset(token)


def materialize(tree):
    """``tree`` with each :class:`LeafRef` made the tensor its layer
    computes with (gathered over the FSDP axes, cast); other leaves as
    they are.  Inside a :func:`sequence` block that splits the sequence
    every leaf's index goes into the run's ``seq_leaves``."""
    run = _SHARD_RUN.get()
    if run is None:
        return tree

    def use(x):
        if isinstance(x, LeafRef):
            return run.materialize(x)
        if _SEQ.get() and hasattr(x, "leaf_index"):
            run.seq_leaves.add(x.leaf_index)
        return x
    return tree_map(use, tree)


@contextlib.contextmanager
def sequence(length: int):
    """Inside the block the residual stream of a sequence of ``length``
    positions is split over ``"model"`` where the active mesh step's
    :meth:`ShardRun.splits` it (Megatron sequence parallelism), else
    whole."""
    run = _SHARD_RUN.get()
    token = _SEQ.set(run is not None and run.splits(length))
    try:
        yield
    finally:
        _SEQ.reset(token)


def seq_split() -> Optional[TensorParallel]:
    """The ``"model"`` axis where the residual stream is split over it
    (inside a :func:`sequence` block that splits), else None."""
    return tp() if _SEQ.get() else None

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

The MoE layer's expert-parallel group is separate: where the JAX package
shards experts over the active mesh's ``"model"`` axis, the port's
``shuffle`` dispatch reads the process group set by
:func:`use_expert_group`; without one it runs the ``einsum`` dispatch, as
the JAX package's does without a ``"model"`` axis.
"""
from __future__ import annotations

import contextlib
import contextvars
import re
from typing import Any, NamedTuple, Optional, Sequence, Tuple

from .._tree import tree_map

_MESH: contextvars.ContextVar[Optional[Any]] = contextvars.ContextVar(
    "repro_torch_mesh", default=None)
_RULE_OVERRIDES: contextvars.ContextVar[Tuple[Tuple[str, Optional[Tuple]],
                                              ...]] = \
    contextvars.ContextVar("repro_torch_rule_overrides", default=())
_EXPERT_GROUP: contextvars.ContextVar[Optional[Any]] = contextvars.ContextVar(
    "repro_torch_expert_group", default=None)


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
    """The ``torch.distributed`` group the experts are sharded over, or
    None."""
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

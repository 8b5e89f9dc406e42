"""A small pytree: flatten, unflatten and map over nested payloads.

Payloads, plan outputs and cost accumulators are nests of dicts, lists,
tuples and NamedTuples with tensors (or arrays, or scalars) at the leaves.
Dicts flatten in sorted-key order and ``None`` is an empty node, as in
``jax.tree_util``, so leaf orders agree with the JAX package's.  A tuple
whose class sets ``_tree_leaf`` (a sharding spec) is a leaf, as JAX's
``PartitionSpec`` is.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(node, leaves: List[Any]):
    if node is None:
        return None
    if getattr(node, "_tree_leaf", False):
        leaves.append(node)
        return "*"
    if isinstance(node, dict):
        keys = sorted(node)
        return (dict, keys, [_walk(node[k], leaves) for k in keys])
    if _is_namedtuple(node):
        return (type(node), None, [_walk(c, leaves) for c in node])
    if isinstance(node, (list, tuple)):
        return (type(node), None, [_walk(c, leaves) for c in node])
    leaves.append(node)
    return "*"


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """Leaves in order, and a structure for :func:`tree_unflatten`.  The
    walk is a module-level function, not a recursive closure: a closure
    that refers to itself is a reference cycle, which would keep the
    leaves (tensors) alive until the garbage collector runs."""
    leaves: List[Any] = []
    return leaves, _walk(tree, leaves)


def _build(s, it):
    if s is None:
        return None
    if s == "*":
        return next(it)
    kind, keys, children = s
    built = [_build(c, it) for c in children]
    if kind is dict:
        return dict(zip(keys, built))
    if kind in (list, tuple):
        return kind(built)
    return kind(*built)                          # NamedTuple


def tree_unflatten(structure, leaves) -> Any:
    return _build(structure, iter(leaves))


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` applied leaf-wise over trees of one structure."""
    leaves, structure = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(structure,
                          [fn(*xs) for xs in zip(leaves, *others)])

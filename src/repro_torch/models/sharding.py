"""The expert-parallel group of the MoE layer.

The port of the ``"model"`` (EP) axis of ``repro.models.sharding``: where
the JAX package reads the active mesh with ``sharding.get_mesh()`` and
shards experts over its ``"model"`` axis, the port reads the process group
set by :func:`use_expert_group`.  Without one, the MoE ``shuffle`` dispatch
runs the ``einsum`` dispatch, as the JAX package's does without a
``"model"`` axis.  The parameter shardings and FSDP rules of the JAX module
have no counterpart here.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Optional

_EXPERT_GROUP: contextvars.ContextVar[Optional[Any]] = contextvars.ContextVar(
    "repro_torch_expert_group", default=None)


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

"""Uniform optimizer interface used by the trainer, and the ZeRO layouts
of its state, as ``repro.optim.api``."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

from .._tree import tree_map
from ..configs.base import ArchConfig
from .adafactor import AdafactorState, adafactor_init, adafactor_update
from .adamw import AdamWState, adamw_init, adamw_update


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params, lr) -> (params, state)
    name: str


def make_optimizer(cfg: ArchConfig) -> Optimizer:
    if cfg.optimizer == "adamw":
        return Optimizer(init=adamw_init, update=adamw_update, name="adamw")
    if cfg.optimizer == "adafactor":
        return Optimizer(init=adafactor_init, update=adafactor_update,
                         name="adafactor")
    raise ValueError(cfg.optimizer)


def state_shardings(opt: Optimizer, param_specs: Any, param_shapes: Any,
                    mesh) -> Any:
    """Optimizer-state specs derived from the *parameter* specs (ZeRO:
    AdamW's moments co-sharded with their parameter; Adafactor's factored
    statistics drop the spec entry of the dimension they average over).
    ``param_shapes`` is a nest of tensors or anything with a ``shape``;
    the step count is replicated (``()``)."""
    from ..models.sharding import use_mesh, validate_spec

    def ns(spec, shape):
        with use_mesh(mesh):
            return validate_spec(tuple(spec), tuple(shape))

    if opt.name == "adamw":
        moments = tree_map(lambda s, p: ns(s, p.shape), param_specs,
                           param_shapes)
        return AdamWState(step=(), m=moments, v=moments)
    if opt.name == "adafactor":
        def vr_sh(s, p):
            shape = tuple(p.shape)
            if len(shape) >= 2:
                return ns(s[:len(shape) - 1], shape[:-1])
            return ns(s, shape)

        def vc_sh(s, p):
            shape = tuple(p.shape)
            if len(shape) >= 2:
                spec = list(s[:len(shape)]) + [None] * (len(shape) - len(s))
                spec = spec[:len(shape) - 2] + [spec[len(shape) - 1]]
                return ns(spec, shape[:-2] + shape[-1:])
            return ns((None,), (1,))

        return AdafactorState(step=(),
                              vr=tree_map(vr_sh, param_specs, param_shapes),
                              vc=tree_map(vc_sh, param_specs, param_shapes))
    raise ValueError(opt.name)

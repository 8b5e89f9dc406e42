"""Uniform optimizer interface used by the trainer, as ``repro.optim.api``.
Of that module only the sharded state layouts (``state_shardings``) are
not ported yet."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

from ..configs.base import ArchConfig
from .adafactor import adafactor_init, adafactor_update
from .adamw import adamw_init, adamw_update


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

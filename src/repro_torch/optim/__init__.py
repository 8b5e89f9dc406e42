"""Optimizers of the training slice: the port of ``repro.optim`` (AdamW,
Adafactor, the warmup-cosine schedule, the uniform interface with its
ZeRO state layouts, and the error-feedback int8 compression of the
cross-pod gradient hop).  They work on a params nest (dicts of tensors, the LM's
``trainable_tree()``) and update the parameters and their state in place
under ``torch.no_grad()``."""
from .adafactor import AdafactorState, adafactor_init, adafactor_update
from .adamw import AdamWState, adamw_init, adamw_update
from . import compress
from .api import Optimizer, make_optimizer, state_shardings
from .schedule import warmup_cosine

__all__ = ["AdamWState", "adamw_init", "adamw_update", "AdafactorState",
           "adafactor_init", "adafactor_update", "warmup_cosine",
           "Optimizer", "make_optimizer", "state_shardings", "compress"]

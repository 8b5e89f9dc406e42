"""Training: the port of ``repro.train`` — the trainer on one device or
over a mesh (:mod:`.zero`, the funnel-reduced ZeRO step), checkpoints,
elastic resume and the GPipe schedule."""
from . import checkpoint, elastic, pipeline
from .trainer import Trainer, TrainConfig, build_train_step

__all__ = ["Trainer", "TrainConfig", "build_train_step", "checkpoint",
           "elastic", "pipeline"]

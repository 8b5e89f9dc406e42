"""Training on one device: the port of ``repro.train``'s trainer and
checkpoints.  The elastic and pipeline-parallel parts belong to the
distributed slice of the port."""
from . import checkpoint
from .trainer import Trainer, TrainConfig, build_train_step

__all__ = ["Trainer", "TrainConfig", "build_train_step", "checkpoint"]

"""Training on one device: the port of ``repro.train.trainer``.

One ``train_step`` is one BSP superstep of the JAX package without the
exchange: the loss and its gradients (``model.loss_fn`` and autograd, with
``ssm_scan``'s backward kernel on the card), then the optimizer's in-place
update.  There is no mesh: the gradient funnel across chips
(``pod_grad_mode="compressed"``) belongs to the distributed slice.

Fault tolerance as in the JAX package: async step-atomic checkpoints every
``ckpt_every`` steps, resume from the latest one, and batches that are a
pure function of the step, so a restart continues the exact data stream.

  tc = TrainConfig(arch=get_config("zamba2-1.2b"), seq_len=2048)
  trainer = Trainer(tc)                 # on the card; device="cpu" to ask
  trainer.maybe_resume()
  result = trainer.train()              # {"history", "final_loss", ...}

The batch moves to the device each step; the loss is read to the host only
when it is logged (every ``log_every`` steps and at the last).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import torch

from .._device import as_device
from .._tree import tree_leaves, tree_map
from ..configs.base import ArchConfig
from ..data import make_pipeline
from ..models import build_model, model_class
from ..optim import make_optimizer
from ..optim.schedule import warmup_cosine
from . import checkpoint as ckpt


@dataclasses.dataclass
class TrainConfig:
    arch: ArchConfig
    global_batch: int = 8
    seq_len: int = 128
    steps: int = 100
    peak_lr: float = 3e-4
    warmup_steps: int = 10
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    seed: int = 0
    pod_grad_mode: str = "auto"        # auto | compressed
    log_every: int = 10


def _one_device(tc: TrainConfig) -> None:
    if tc.pod_grad_mode == "compressed":
        raise NotImplementedError(
            "pod_grad_mode='compressed' reduces gradients across pods; it "
            "comes with the distributed slice of the port")


def build_train_step(tc: TrainConfig, model, opt):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``: ``params`` is the model's ``trainable_tree()``, which the step
    updates in place; ``loss`` stays on the device."""
    _one_device(tc)

    def lr_at(step):
        return warmup_cosine(step, peak_lr=tc.peak_lr,
                             warmup_steps=tc.warmup_steps,
                             total_steps=max(tc.steps, 2 * tc.warmup_steps))

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None
        loss, _ = model.loss_fn(batch)
        loss.backward()
        grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                         else p.grad, params)
        params, opt_state = opt.update(grads, opt_state, params,
                                       lr_at(opt_state.step))
        for p in leaves:
            p.grad = None
        return params, opt_state, loss.detach()

    return train_step


class Trainer:
    """The training loop over ``tc.arch``'s model on ``device`` (the card
    unless the caller asks for the CPU).  ``params``, when given, is the
    params nest to start from (numpy arrays or tensors under the JAX
    package's names, e.g. the JAX trainer's initial params); otherwise the
    params are drawn from a generator seeded with ``tc.seed``."""

    def __init__(self, tc: TrainConfig, device="cuda", params=None):
        _one_device(tc)
        self.tc = tc
        self.device = as_device(device, "trainer")
        if params is None:
            self.model = build_model(tc.arch, device=self.device,
                                     seed=tc.seed)
        else:
            self.model = model_class(tc.arch)(tc.arch, tree_map(
                lambda a: torch.as_tensor(a).detach().to(self.device,
                                                         copy=True),
                params))
        self.opt = make_optimizer(tc.arch)
        self.pipeline = make_pipeline(tc.arch, tc.global_batch, tc.seq_len,
                                      seed=tc.seed)
        self.saver = ckpt.AsyncSaver()
        self.step = 0
        self.history: list = []
        self.params = self.model.trainable_tree()
        self.opt_state = self.opt.init(self.params)
        self._step_fn = build_train_step(tc, self.model, self.opt)

    def state_tree(self) -> Dict[str, Any]:
        """What a checkpoint holds: {"params", "opt_state"}."""
        return {"params": self.params, "opt_state": self.opt_state}

    def maybe_resume(self) -> bool:
        tc = self.tc
        if not tc.ckpt_dir:
            return False
        last = ckpt.latest_step(tc.ckpt_dir)
        if last is None:
            return False
        restored, meta = ckpt.restore(tc.ckpt_dir, last, self.state_tree())
        with torch.no_grad():
            for p, r in zip(tree_leaves(self.params),
                            tree_leaves(restored["params"])):
                p.copy_(r)
        self.opt_state = restored["opt_state"]
        self.step = int(meta["step"])
        return True

    def train(self, steps: Optional[int] = None) -> Dict[str, Any]:
        """Train until step ``steps`` (default ``tc.steps``); returns the
        logged (step, loss) history, the final loss and the wall time."""
        tc = self.tc
        steps = steps if steps is not None else tc.steps
        t0 = time.time()
        while self.step < steps:
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.pipeline.batch_at(self.step).items()}
            self.params, self.opt_state, loss = self._step_fn(
                self.params, self.opt_state, batch)
            self.step += 1
            if self.step % tc.log_every == 0 or self.step == steps:
                self.history.append((self.step, float(loss)))
            if tc.ckpt_dir and self.step % tc.ckpt_every == 0:
                self.saver.save_async(
                    tc.ckpt_dir, self.step, self.state_tree(),
                    extra_meta={"arch": tc.arch.name, "seed": tc.seed})
        self.saver.wait()
        return {"history": self.history, "final_loss": self.history[-1][1]
                if self.history else None,
                "wall_s": time.time() - t0}

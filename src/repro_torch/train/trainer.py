"""The training loop, on one device or over a mesh: the port of
``repro.train.trainer``.

One ``train_step`` is one BSP superstep.  Without a mesh it is the local
half alone: the loss and its gradients (``model.loss_fn`` and autograd,
with ``ssm_scan``'s backward kernel on the card), then the optimizer's
in-place update.  With a mesh (a ``DeviceMesh`` over ``("pod", "data",
"model")``, e.g. :func:`repro_torch.launch.mesh.make_host_mesh`) the step
is :class:`repro_torch.train.zero.MeshStep`: every rank stores only its
shards of the parameters and the optimizer state (FSDP-3 and ZeRO over
``("pod", "data")``, Megatron tensor parallelism over ``"model"``, every
family, MoE with the global batch's router statistics and capacity
groups); each rank's rows of the batch, each layer's parameters gathered
where it runs, the two-level gradient funnel (reduce-scatter over
``"data"``, then the ``"pod"`` hop) and the update of the rank's shards
in place.  The pod hop follows ``pod_grad_mode``:

  'auto'        an exact SUM;
  'compressed'  the error-feedback int8 funnel (``optim.compress``),
                cutting the hop's bytes 4x.  Without a ``"pod"`` axis (or
                without a mesh) it is the exact step, as in the JAX
                package.

Fault tolerance as in the JAX package: async step-atomic checkpoints every
``ckpt_every`` steps, resume from the latest one, and batches that are a
pure function of the step, so a restart continues the exact data stream.
Checkpoints are topology-agnostic: a mesh trainer gathers its state to
whole logical tensors and rank 0 writes them in the JAX package's format;
on restore every rank takes its shard, on any mesh.

  tc = TrainConfig(arch=get_config("zamba2-1.2b"), seq_len=2048)
  trainer = Trainer(tc)                 # on the card; device="cpu" to ask
  trainer = Trainer(tc, mesh=make_host_mesh())   # every rank of a group
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
from .zero import MeshStep


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


def _lr_schedule(tc: TrainConfig):
    def lr_at(step):
        return warmup_cosine(step, peak_lr=tc.peak_lr,
                             warmup_steps=tc.warmup_steps,
                             total_steps=max(tc.steps, 2 * tc.warmup_steps))
    return lr_at


def build_train_step(tc: TrainConfig, model, opt):
    """The one-device step: ``train_step(params, opt_state, batch) ->
    (params, opt_state, loss)``, where ``params`` is the model's
    ``trainable_tree()``, updated in place, and ``loss`` stays on the
    device.  The mesh step is :class:`repro_torch.train.zero.MeshStep`,
    which :class:`Trainer` builds when it is given a mesh."""
    lr_at = _lr_schedule(tc)

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
    params are drawn from a generator seeded with ``tc.seed``.  ``mesh``,
    a ``DeviceMesh`` this rank belongs to, makes every rank of it run the
    mesh step together (the same ``tc`` and params on each)."""

    def __init__(self, tc: TrainConfig, device="cuda", params=None,
                 mesh=None):
        self.tc = tc
        self.mesh = mesh
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
        self._mesh_step = None
        self.ef_state = None
        if mesh is None:
            self.opt_state = self.opt.init(self.params)
            self._step_fn = build_train_step(tc, self.model, self.opt)
        else:
            self._mesh_step = MeshStep(
                self.model, self.opt, mesh, _lr_schedule(tc),
                compressed=tc.pod_grad_mode == "compressed")
            self.opt_state = self.opt.init(self.params)
            self.ef_state = self._mesh_step.init_ef(self.params)

    @property
    def is_writer(self) -> bool:
        """Whether this rank writes checkpoints (rank 0 of a mesh)."""
        return self.mesh is None or all(
            c == 0 for c in self.mesh.get_coordinate())

    def state_tree(self) -> Dict[str, Any]:
        """What a checkpoint holds: {"params", "opt_state"}, as whole
        logical tensors (with a mesh, gathered: every rank must call)."""
        if self._mesh_step is None:
            return {"params": self.params, "opt_state": self.opt_state}
        return {"params": self._mesh_step.gather_params(self.params),
                "opt_state": self._mesh_step.gather_state(self.opt_state)}

    def maybe_resume(self) -> bool:
        tc = self.tc
        if not tc.ckpt_dir:
            return False
        last = ckpt.latest_step(tc.ckpt_dir)
        if last is None:
            return False
        step = self._mesh_step
        if step is None:
            target = self.state_tree()
        else:
            target = {"params": step.whole_like(self.params),
                      "opt_state": step.gather_state(self.opt_state)}
        restored, meta = ckpt.restore(tc.ckpt_dir, last, target)
        if step is None:
            with torch.no_grad():
                for p, r in zip(tree_leaves(self.params),
                                tree_leaves(restored["params"])):
                    p.copy_(r)
            self.opt_state = restored["opt_state"]
        else:
            step.load_params(self.params, restored["params"])
            self.opt_state = step.shard_state(restored["opt_state"])
        self.step = int(meta["step"])
        return True

    def train(self, steps: Optional[int] = None) -> Dict[str, Any]:
        """Train until step ``steps`` (default ``tc.steps``); returns the
        logged (step, loss) history, the final loss and the wall time."""
        tc = self.tc
        steps = steps if steps is not None else tc.steps
        t0 = time.time()
        while self.step < steps:
            batch = self.pipeline.batch_at(self.step)
            if self._mesh_step is not None:
                batch = self._mesh_step.local_rows(batch)
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in batch.items()}
            if self._mesh_step is None:
                self.params, self.opt_state, loss = self._step_fn(
                    self.params, self.opt_state, batch)
            else:
                (self.params, self.opt_state, self.ef_state,
                 loss) = self._mesh_step.step_local(
                     self.params, self.opt_state, self.ef_state, batch)
            self.step += 1
            if self.step % tc.log_every == 0 or self.step == steps:
                self.history.append((self.step, float(loss)))
            if tc.ckpt_dir and self.step % tc.ckpt_every == 0:
                tree = self.state_tree()
                if self.is_writer:
                    self.saver.save_async(
                        tc.ckpt_dir, self.step, tree,
                        extra_meta={"arch": tc.arch.name, "seed": tc.seed})
        self.saver.wait()
        if self._mesh_step is not None:
            self._mesh_step.g.barrier(self.device)
        return {"history": self.history, "final_loss": self.history[-1][1]
                if self.history else None,
                "wall_s": time.time() - t0}

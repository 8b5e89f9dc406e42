"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
      --reduced --steps 50 --batch 8 --seq 64 --device cpu \\
      [--ckpt-dir /tmp/run1]

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen1.5-0.5b --reduced --device cpu --mesh host \\
      [--pod-grad-mode compressed]

``--arch`` takes any of the ten configs: the dense ones, ``zamba2-1.2b``,
``rwkv6-1.6b``, the MoE ``kimi-k2-1t-a32b`` and ``llama4-scout-17b-a16e``,
the VLM ``internvl2-2b`` and the enc-dec ``whisper-base``.  Trains on the
card (``--device cuda``, the default) unless asked for the CPU.

``--mesh host`` trains on every rank of a process group started from
torchrun's environment (NCCL on the card, one rank a card; gloo with
``--device cpu``) over a ``("pod", "data", "model")`` mesh of
``make_host_mesh``: ``(1, world, 1)``, or the ``--mesh-shape P,D,M``
given (any family; ``"model"`` > 1 splits heads, d_ff, the vocabulary
and the experts); ``--mesh none`` (the default) trains on one device.
The loop is restart-safe: launching again with the same ``--ckpt-dir``
resumes exactly, on any mesh.  Rank 0 prints the JAX
launcher's JSON line.
"""
import argparse
import json
import os

import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, get_config
from ..train import Trainer, TrainConfig
from .mesh import make_host_mesh


def _host_mesh(device: str, shape=None):
    """Start the process group from torchrun's environment and build the
    host mesh (``shape`` (pod, data, model), or ``(1, world, 1)``); on the
    card each rank takes the card of its local rank."""
    if device.startswith("cuda"):
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")
    if shape is None:
        return make_host_mesh()
    return make_host_mesh(shape, ("pod", "data", "model"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", choices=["host", "none"], default="none")
    ap.add_argument("--mesh-shape", default=None,
                    help="P,D,M: the (pod, data, model) sizes of --mesh "
                         "host (default 1,world,1)")
    ap.add_argument("--pod-grad-mode", choices=["auto", "compressed"],
                    default="auto")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    shape = (tuple(int(n) for n in args.mesh_shape.split(","))
             if args.mesh_shape else None)
    mesh = _host_mesh(args.device, shape) if args.mesh == "host" else None
    device = args.device
    if mesh is not None and device == "cuda":
        device = f"cuda:{torch.cuda.current_device()}"
    try:
        tc = TrainConfig(arch=cfg, global_batch=args.batch, seq_len=args.seq,
                         steps=args.steps, peak_lr=args.lr,
                         ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         seed=args.seed, pod_grad_mode=args.pod_grad_mode)
        trainer = Trainer(tc, device=device, mesh=mesh)
        if trainer.maybe_resume() and trainer.is_writer:
            print(f"resumed from step {trainer.step}")
        result = trainer.train()
        if trainer.is_writer:
            print(json.dumps({"arch": cfg.name, "steps": trainer.step,
                              "final_loss": result["final_loss"],
                              "wall_s": round(result["wall_s"], 1),
                              "history": result["history"][-5:]}))
    finally:
        if mesh is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()

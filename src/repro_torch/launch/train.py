"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
      --reduced --steps 50 --batch 8 --seq 64 --device cpu \\
      [--ckpt-dir /tmp/run1]

``--arch`` takes any config of a ported family (the dense ones,
``zamba2-1.2b``, ``rwkv6-1.6b``).  Trains on the card (``--device cuda``,
the default) unless asked for the CPU.  The loop is restart-safe:
launching again with the same ``--ckpt-dir`` resumes exactly.  Prints the
JAX launcher's JSON line.
"""
import argparse
import json

from ..configs import ARCH_IDS, get_config
from ..train import Trainer, TrainConfig


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
    ap.add_argument("--pod-grad-mode", choices=["auto", "compressed"],
                    default="auto")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    tc = TrainConfig(arch=cfg, global_batch=args.batch, seq_len=args.seq,
                     steps=args.steps, peak_lr=args.lr,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     seed=args.seed, pod_grad_mode=args.pod_grad_mode)
    trainer = Trainer(tc, device=args.device)
    if trainer.maybe_resume():
        print(f"resumed from step {trainer.step}")
    result = trainer.train()
    print(json.dumps({"arch": cfg.name, "steps": trainer.step,
                      "final_loss": result["final_loss"],
                      "wall_s": round(result["wall_s"], 1),
                      "history": result["history"][-5:]}))


if __name__ == "__main__":
    main()

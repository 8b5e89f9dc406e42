"""End-to-end training driver: ~100M-parameter LM for a few hundred steps.

  python -m repro_torch.examples.train_lm [--device cpu] [--steps 200] \
      [--arch qwen1.5-0.5b]

The port of the JAX package's ``examples/train_lm.py``.  It builds a
~100M-param variant of the chosen architecture family, trains it with the
port's ``Trainer`` on the synthetic Zipf+Markov corpus with a checkpoint
every 50 steps, and prints the loss curve and one JSON line.  Re-running
with the same ``--ckpt-dir`` resumes from its newest checkpoint.
"""
import dataclasses
import json
import pathlib
import tempfile

from repro_torch._tree import tree_leaves
from repro_torch.configs import get_config
from repro_torch.train import TrainConfig, Trainer

from ._common import parser


def hundred_m_config(arch: str):
    """~100M-param family member: d=640, 12 layers, vocab 32k, float32 —
    the JAX example's config of the same name.  For the encoder-decoder
    family that one passes ``n_layers`` twice and raises; here its decoder
    takes the 8 layers and its encoder the 4 that it names."""
    base = get_config(arch)
    fields = dict(
        n_layers=12, d_model=640, n_heads=10,
        n_kv_heads=min(base.n_kv_heads, 10), d_ff=2560, vocab_size=32768,
        head_dim=64, param_dtype="float32", compute_dtype="float32",
        scan_layers=True if base.family in ("dense", "moe", "vlm", "ssm")
        else base.scan_layers)
    if base.is_moe:
        fields.update(n_experts=8, top_k=2, moe_d_ff=512)
    if base.family == "encdec":
        fields.update(n_layers=8, enc_layers=4)
    if base.family == "hybrid":
        fields.update(shared_attn_period=3)
    return dataclasses.replace(base, **fields)


def run(cfg, dev, steps: int, batch: int, seq: int, ckpt_dir,
        ckpt_every: int = 50) -> dict:
    """Train ``cfg`` on ``dev`` to step ``steps`` (resuming from
    ``ckpt_dir``'s newest checkpoint if it has one), a checkpoint every
    ``ckpt_every`` steps; prints the curve and the JSON line and returns
    the trainer's result with ``params`` and ``resumed_at`` (None when it
    started afresh)."""
    tc = TrainConfig(arch=cfg, global_batch=batch, seq_len=seq, steps=steps,
                     peak_lr=6e-4, warmup_steps=20, ckpt_dir=str(ckpt_dir),
                     ckpt_every=ckpt_every, log_every=10)
    t = Trainer(tc, device=dev)
    n = sum(p.numel() for p in tree_leaves(t.params))
    print(f"training {cfg.name}-family model: {n/1e6:.1f}M params, "
          f"{steps} steps @ batch {batch} x seq {seq}")
    resumed_at = None
    if t.maybe_resume():
        resumed_at = t.step
        print(f"resumed at step {t.step}")
    result = t.train()
    for step, loss in result["history"]:
        print(f"  step {step:5d}  loss {loss:.4f}")
    print(json.dumps({"final_loss": result["final_loss"],
                      "wall_s": round(result["wall_s"], 1)}))
    return {**result, "params": n, "resumed_at": resumed_at}


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=str(
        pathlib.Path(tempfile.gettempdir()) / "repro_torch_train_lm"),
        help="checkpoint directory (default: repro_torch_train_lm in the "
             "temp directory)")
    args = ap.parse_args(argv)
    return run(hundred_m_config(args.arch), args.device,
               args.steps, args.batch, args.seq, args.ckpt_dir)


if __name__ == "__main__":
    main()

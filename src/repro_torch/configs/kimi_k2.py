"""kimi-k2-1t-a32b [moe]: trillion-param MoE, 384 experts top-8
(arXiv:2501.kimi2, paper table).  The flagship exercise of the paper's
shuffle/sort/prefix-sum dispatch.  Adafactor + bf16 master params keep the
1.04T-param state inside 256x16GB (see EXPERIMENTS.md memory analysis)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, moe_d_ff=2048, vocab_size=163840, head_dim=112,
    n_experts=384, top_k=8, shared_expert=True, capacity_factor=1.25,
    norm="rmsnorm", act="silu",
    optimizer="adafactor", param_dtype="bfloat16", remat="full",
    grad_accum=8,                   # memory: see EXPERIMENTS.md kimi analysis
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, moe_d_ff=96, vocab_size=256, head_dim=16,
        n_experts=8, top_k=2,
        optimizer="adamw", param_dtype="float32", compute_dtype="float32")

"""llama4-scout-17b-a16e [moe]: 16 experts top-1 + shared expert
(hf:meta-llama/Llama-4-Scout-17B-16E)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, moe_d_ff=8192, vocab_size=202048, head_dim=128,
    n_experts=16, top_k=1, shared_expert=True, capacity_factor=1.25,
    norm="rmsnorm", act="silu", grad_accum=8,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, moe_d_ff=96, vocab_size=256, head_dim=16,
        n_experts=4, top_k=1,
        param_dtype="float32", compute_dtype="float32")

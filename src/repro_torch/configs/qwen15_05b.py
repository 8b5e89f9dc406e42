"""qwen1.5-0.5b [dense]: QKV bias (hf:Qwen/Qwen1.5-0.5B)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab_size=151936, head_dim=64,
    norm="rmsnorm", act="silu", qkv_bias=True, tie_embeddings=True,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=96, vocab_size=256, head_dim=16,
        param_dtype="float32", compute_dtype="float32")

"""tinyllama-1.1b [dense]: llama2-arch small (arXiv:2401.02385; hf)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=5632, vocab_size=32000, head_dim=64,
    norm="rmsnorm", act="silu", grad_accum=2,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=8, n_kv_heads=1,
        d_ff=96, vocab_size=256, head_dim=8,
        param_dtype="float32", compute_dtype="float32")

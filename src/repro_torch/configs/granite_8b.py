"""granite-8b [dense]: llama-arch code model (arXiv:2405.04324; hf)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=49152, head_dim=128,
    norm="rmsnorm", act="silu",
    replicate_kv_proj=True,   # §Perf H2: kills per-layer KV all-gather
    grad_accum=4,             # scan-carry memory: 59 -> ~20 GB/dev
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        param_dtype="float32", compute_dtype="float32")

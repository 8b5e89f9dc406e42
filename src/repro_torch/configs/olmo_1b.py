"""olmo-1b [dense]: non-parametric LayerNorm (arXiv:2402.00838; hf)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=50304, head_dim=128,
    norm="nonparam_ln", act="silu", tie_embeddings=True,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256, head_dim=16,
        param_dtype="float32", compute_dtype="float32")

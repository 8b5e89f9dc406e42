"""internvl2-2b [vlm]: InternViT (STUB frontend: precomputed patch
embeddings) + InternLM2-1.8B backbone (arXiv:2404.16821; hf)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab_size=92553, head_dim=128,
    norm="rmsnorm", act="silu", n_patches=256, grad_accum=2,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16, n_patches=8,
        param_dtype="float32", compute_dtype="float32")

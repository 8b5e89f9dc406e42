"""rwkv6-1.6b [ssm]: Finch, data-dependent decay (arXiv:2404.05892).
Attention-free -> runs the long_500k cell with O(1) state."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm", rwkv=True,
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab_size=65536,
    ssm_chunk=64, subquadratic=True, grad_accum=4,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, d_ff=256, vocab_size=256,
        ssm_chunk=8, param_dtype="float32", compute_dtype="float32")

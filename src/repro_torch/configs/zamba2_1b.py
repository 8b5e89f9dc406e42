"""zamba2-1.2b [hybrid]: Mamba2 stack + shared attention blocks
(arXiv:2411.15242; hf).  Sub-quadratic -> runs the long_500k cell."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=64,
    ssm_state=64, ssm_expand=2, ssm_chunk=128, shared_attn_period=6,
    norm="rmsnorm", act="silu", subquadratic=True, scan_layers=False,
    grad_accum=2,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256, head_dim=16, ssm_state=16, ssm_chunk=8,
        shared_attn_period=2,
        param_dtype="float32", compute_dtype="float32")

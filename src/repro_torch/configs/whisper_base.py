"""whisper-base [audio]: enc-dec transformer backbone; the conv audio
frontend is a STUB — input_specs feeds precomputed frame embeddings
(arXiv:2212.04356)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="encdec",
    n_layers=6, enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab_size=51865, head_dim=64,
    norm="layernorm", act="gelu", use_rope=False, n_frames=1500,
    scan_layers=False, replicate_attn=True,   # 8 heads < 16-wide TP axis
    grad_accum=4,
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, enc_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=256, head_dim=16, n_frames=16,
        param_dtype="float32", compute_dtype="float32")

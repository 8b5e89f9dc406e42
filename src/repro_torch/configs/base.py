"""Architecture + run configuration: a copy of the JAX package's configs, so
that the port reads the same published shapes without importing it.

Every assigned architecture gets one module in this package defining
``CONFIG`` (the exact published shape) and ``reduced()`` (a tiny same-family
variant for CPU smoke tests).  ``repro_torch.configs.registry`` maps --arch ids to
these modules.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str
    family: str                       # dense | moe | hybrid | ssm | encdec | vlm
    # transformer backbone
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    n_kv_heads: int = 12
    d_ff: int = 3072
    vocab_size: int = 32000
    head_dim: Optional[int] = None    # default d_model // n_heads
    # flavor knobs
    norm: str = "rmsnorm"             # rmsnorm | layernorm | nonparam_ln
    qkv_bias: bool = False            # qwen1.5
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True             # whisper: sinusoidal abs pos instead
    act: str = "silu"                 # silu (SwiGLU) | gelu
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: Optional[int] = None    # expert FFN width (kimi: 2048)
    shared_expert: bool = False
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0                # mamba2 d_state
    ssm_expand: int = 2
    ssm_chunk: int = 128
    shared_attn_period: int = 0       # zamba2: shared attn block every k layers
    # RWKV
    rwkv: bool = False
    # encoder-decoder (whisper)
    enc_layers: int = 0
    n_frames: int = 0                 # audio frontend stub output length
    # VLM (internvl2)
    n_patches: int = 0                # vision frontend stub output length
    # training
    param_dtype: str = "float32"      # master params
    compute_dtype: str = "bfloat16"
    optimizer: str = "adamw"          # adamw | adafactor
    remat: str = "full"               # none | dots | full
    grad_accum: int = 1               # microbatches per step (memory knob)
    scan_layers: bool = True
    max_seq: int = 8192               # rope table length hint (decode may exceed)
    # MoE dispatch flavor: 'einsum' (dense one-hot; XLA collectives) or
    # 'shuffle' (explicit sort + all_to_all — the paper-faithful path)
    moe_dispatch: str = "einsum"
    # attention implementation: 'flash' (Pallas kernel) | 'xla' (dot-product)
    attn_impl: str = "xla"
    # Megatron-style sequence parallelism: residual-stream activations (and
    # scan-remat carries) sharded over the 'model' axis along the sequence
    # dim.  Cuts per-layer saved-activation memory |model|x at the cost of
    # per-layer gather/scatter collectives.
    seq_shard_activations: bool = False
    # Replicate ALL attention weights across the TP axis (small archs whose
    # head count < |model|, e.g. whisper's 8 heads on 16 ranks).
    replicate_attn: bool = False
    # Replicate the (small) K/V projection weights across the TP axis so
    # every rank computes the full KV locally — removes the per-layer KV
    # all-gather at ~(kvh/h) extra projection FLOPs.  Wins when GQA kv_heads
    # don't divide the model axis (see EXPERIMENTS.md §Perf H2).
    replicate_kv_proj: bool = False
    # sub-quadratic attention available (family-level; gates long_500k)
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the vocab-parallel
        embedding/lm-head shard over any mesh axis (92553, 51865 etc. cannot
        shard over 16 and would replicate ~GB-scale logits).  Logits beyond
        ``vocab_size`` are masked to -inf in apply_lm_head."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def n_params(self) -> int:
        """Analytic parameter count (embeddings + backbone), for roofline's
        MODEL_FLOPS = 6*N*D."""
        d, hd = self.d_model, self.hd
        p = self.vocab_size * d                    # embed
        if not self.tie_embeddings:
            p += d * self.vocab_size               # lm head
        def attn():
            return (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                    + self.n_heads * hd * d)
        def mlp(ff):
            return 3 * d * ff if self.act == "silu" else 2 * d * ff
        if self.family in ("dense", "vlm"):
            p += self.n_layers * (attn() + mlp(self.d_ff) + 2 * d)
        elif self.family == "moe":
            eff = self.moe_d_ff or self.d_ff
            per = attn() + self.n_experts * 3 * d * eff + d * self.n_experts
            if self.shared_expert:
                per += 3 * d * eff
            p += self.n_layers * (per + 2 * d)
        elif self.family == "hybrid":
            d_in = self.ssm_expand * d
            per_mamba = (d * (2 * d_in + 2 * self.ssm_state + self.n_heads)
                         + d_in * d + 2 * d)
            p += self.n_layers * per_mamba
            if self.shared_attn_period:
                p += attn() + mlp(self.d_ff) + 2 * d       # one shared block
        elif self.family == "ssm":                         # rwkv6
            per = (4 * d * d          # r, k, v, gate
                   + d * d            # output
                   + 2 * d * 64       # decay lora
                   + d * self.d_ff + self.d_ff * d)        # channel mix
            p += self.n_layers * (per + 2 * d)
        elif self.family == "encdec":
            enc = self.enc_layers * (attn() + 2 * d * self.d_ff + 2 * d)
            dec = self.n_layers * (2 * attn() + 2 * d * self.d_ff + 3 * d)
            p += enc + dec
        return p

    def n_active_params(self) -> int:
        """Active params per token (= N_active for MoE MODEL_FLOPS)."""
        if not self.is_moe:
            return self.n_params()
        d = self.d_model
        eff = self.moe_d_ff or self.d_ff
        dense_per = (d * self.n_heads * self.hd
                     + 2 * d * self.n_kv_heads * self.hd
                     + self.n_heads * self.hd * d
                     + d * self.n_experts + 2 * d)
        act_ffn = self.top_k * 3 * d * eff
        if self.shared_expert:
            act_ffn += 3 * d * eff
        p = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return p + self.n_layers * (dense_per + act_ffn)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether the (arch, shape) cell runs; reason when skipped
    (DESIGN.md §4)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("full quadratic attention: 524k-token decode needs "
                       "sub-quadratic attention (run for SSM/hybrid only)")
    return True, ""

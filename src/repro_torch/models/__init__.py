"""The LM stack of the port: shared layers, the MoE layer, the Mamba2 and
RWKV6 blocks, and the dense, MoE, VLM, hybrid, RWKV6 and encoder-decoder
LMs."""
from .encdec import EncDecLM, EncDecState, build_encdec
from .moe import MoEOut
from .sharding import expert_group, use_expert_group
from .transformer import (DecoderLM, HybridDecodeState, HybridLM,
                          KVDecodeState, RWKVDecodeState, RWKVLM,
                          build_decoder_lm, build_hybrid_lm, build_model,
                          build_rwkv_lm, init_params, model_class)

__all__ = ["DecoderLM", "HybridLM", "RWKVLM", "EncDecLM", "KVDecodeState",
           "HybridDecodeState", "RWKVDecodeState", "EncDecState", "MoEOut",
           "build_model", "build_decoder_lm", "build_hybrid_lm",
           "build_rwkv_lm", "build_encdec", "init_params", "model_class",
           "use_expert_group", "expert_group"]

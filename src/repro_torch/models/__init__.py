"""The LM stack of the port: shared layers, the Mamba2 and RWKV6 blocks,
and the dense, hybrid and RWKV6 decoder LMs."""
from .transformer import (DecoderLM, HybridDecodeState, HybridLM,
                          KVDecodeState, RWKVDecodeState, RWKVLM,
                          build_model, init_params, model_class)

__all__ = ["DecoderLM", "HybridLM", "RWKVLM", "KVDecodeState",
           "HybridDecodeState", "RWKVDecodeState", "build_model",
           "init_params", "model_class"]

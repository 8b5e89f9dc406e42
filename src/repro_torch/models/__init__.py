"""The LM stack of the port: shared layers and the dense decoder."""
from .transformer import DecoderLM, KVDecodeState, build_model, init_params

__all__ = ["DecoderLM", "KVDecodeState", "build_model", "init_params"]

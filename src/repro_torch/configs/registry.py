"""--arch id -> config module registry."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from .base import ArchConfig

_MODULES: Dict[str, str] = {
    "granite-8b": "granite_8b",
    "tinyllama-1.1b": "tinyllama_1b",
    "olmo-1b": "olmo_1b",
    "qwen1.5-0.5b": "qwen15_05b",
    "zamba2-1.2b": "zamba2_1b",
    "rwkv6-1.6b": "rwkv6_1b",
    "kimi-k2-1t-a32b": "kimi_k2",
    "llama4-scout-17b-a16e": "llama4_scout",
    "whisper-base": "whisper_base",
    "internvl2-2b": "internvl2_2b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, reduced: bool = False, **overrides) -> ArchConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    cfg = mod.reduced() if reduced else mod.CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg

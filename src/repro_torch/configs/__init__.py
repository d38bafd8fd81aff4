"""Assigned-architecture registry: ``--arch <id>`` resolves here."""
from __future__ import annotations

import importlib

ARCHS = (
    "llama3.2-3b",
    "gemma3-1b",
    "gemma2-9b",
    "llama3-8b",
    "phi3.5-moe-42b-a6.6b",
    "deepseek-v3-671b",
    "whisper-medium",
    "paligemma-3b",
    "rwkv6-3b",
    "zamba2-1.2b",
)

_MODULES = {
    "llama3.2-3b": "llama3_2_3b",
    "gemma3-1b": "gemma3_1b",
    "gemma2-9b": "gemma2_9b",
    "llama3-8b": "llama3_8b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "deepseek-v3-671b": "deepseek_v3",
    "whisper-medium": "whisper_medium",
    "paligemma-3b": "paligemma_3b",
    "rwkv6-3b": "rwkv6_3b",
    "zamba2-1.2b": "zamba2_1_2b",
}


def get_config(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG

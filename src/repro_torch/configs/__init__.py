"""Configs of the port: the recsys models and the LM registry.

``get_config("<arch-id>")`` knows the ten architecture ids of
``repro.configs`` and returns each: the attention-family transformers
(granite-8b, gemma2-27b, gemma3-12b, starcoder2-3b, phi3.5-moe-42b-a6.6b,
kimi-k2-1t-a32b), the Mamba2/SSD models (mamba2-780m, and zamba2-2.7b
with its shared attention) and the two with ``cross`` layers over a
memory (llama-3.2-vision-11b over stub image embeddings,
seamless-m4t-medium over its audio encoder's output).  The port serves
and trains all ten.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPES, GBAConfig, InputShape,
                                      ModelConfig)
from repro_torch.configs.recsys import (ALIMAMA_DIEN, CRITEO_DEEPFM,
                                        PRIVATE_YOUTUBEDNN, RECSYS_CONFIGS,
                                        RecsysConfig)

ARCH_IDS = ("kimi-k2-1t-a32b", "granite-8b", "zamba2-2.7b", "gemma3-12b",
            "mamba2-780m", "starcoder2-3b", "phi3.5-moe-42b-a6.6b",
            "seamless-m4t-medium", "llama-3.2-vision-11b", "gemma2-27b")

# the architectures and their modules
_ARCH_MODULES = {
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "granite-8b": "granite_8b",
    "gemma3-12b": "gemma3_12b",
    "starcoder2-3b": "starcoder2_3b",
    "phi3.5-moe-42b-a6.6b": "phi3p5_moe_42b_a6p6b",
    "gemma2-27b": "gemma2_27b",
    "mamba2-780m": "mamba2_780m",
    "zamba2-2.7b": "zamba2_2p7b",
    "llama-3.2-vision-11b": "llama3p2_vision_11b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    """Every architecture's config, in ``ARCH_IDS`` order."""
    return {arch: get_config(arch) for arch in ARCH_IDS}


__all__ = ["ALIMAMA_DIEN", "ARCH_IDS", "CRITEO_DEEPFM", "GBAConfig",
           "INPUT_SHAPES", "InputShape", "ModelConfig", "PRIVATE_YOUTUBEDNN", "RECSYS_CONFIGS",
           "RecsysConfig", "all_configs", "get_config"]

"""Configs of the port: the recsys models and the LM registry.

``get_config("<arch-id>")`` knows the ten architecture ids of
``repro.configs``.  The port runs the dense transformer only, so it returns
``granite-8b`` and raises ``NotImplementedError`` for the other nine,
which wait in ROADMAP.md's queue of modules to port.
"""
from __future__ import annotations

from repro_torch.configs.base import GBAConfig, ModelConfig
from repro_torch.configs.recsys import (ALIMAMA_DIEN, CRITEO_DEEPFM,
                                        PRIVATE_YOUTUBEDNN, RECSYS_CONFIGS,
                                        RecsysConfig)

ARCH_IDS = ("kimi-k2-1t-a32b", "granite-8b", "zamba2-2.7b", "gemma3-12b",
            "mamba2-780m", "starcoder2-3b", "phi3.5-moe-42b-a6.6b",
            "seamless-m4t-medium", "llama-3.2-vision-11b", "gemma2-27b")


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    if arch != "granite-8b":
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet: the port runs the dense "
            f"transformer of granite-8b; the other architectures wait in "
            f"ROADMAP.md's queue of modules to port")
    from repro_torch.configs.granite_8b import CONFIG
    return CONFIG


__all__ = ["ALIMAMA_DIEN", "ARCH_IDS", "CRITEO_DEEPFM", "GBAConfig",
           "ModelConfig", "PRIVATE_YOUTUBEDNN", "RECSYS_CONFIGS",
           "RecsysConfig", "get_config"]

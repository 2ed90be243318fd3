"""Gemma 3 12B [hf:google/gemma-3-1b-pt family], as in
``repro.configs.gemma3_12b``.

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144 — 5 local : 1 global
attention, 128k context, sliding window 1024.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    d_ff=15360,
    vocab_size=262_144,
    head_dim=256,
    block_pattern=("local", "local", "local", "local", "local", "global"),
    sliding_window=1024,
    norm="rmsnorm",
    source="hf:google/gemma-3-1b-pt",
)

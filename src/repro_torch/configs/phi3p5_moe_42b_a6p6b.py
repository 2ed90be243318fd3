"""Phi-3.5-MoE 42B (6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct], as in
``repro.configs.phi3p5_moe_42b_a6p6b``.

32L d_model=4096 32H (GQA kv=8) d_ff=6400/expert vocab=32064 — 16 experts,
top-2 routing.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32_064,
    block_pattern=("moe",),
    num_experts=16,
    experts_per_token=2,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)

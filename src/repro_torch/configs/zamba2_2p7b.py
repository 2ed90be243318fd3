"""Zamba2-2.7B — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242], as in ``repro.configs.zamba2_2p7b``.

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000 ssm_state=64.
Pattern: 5 Mamba2 blocks then 1 Mamba2+shared-attention block, repeated 9x.
The shared block is the reference's simplification of the published
model: one set of attention weights (no MLP, no LoRA), so d_ff is unused.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32_000,
    block_pattern=("mamba", "mamba", "mamba", "mamba", "mamba", "mamba_attn"),
    ssm_state=64,
    source="arXiv:2411.15242",
)

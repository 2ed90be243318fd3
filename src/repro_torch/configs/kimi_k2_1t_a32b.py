"""Kimi K2 — trillion-parameter MoE (paper-table) [arXiv:2501.kimi2], as in
``repro.configs.kimi_k2_1t_a32b``.

61L d_model=7168 64H (GQA kv=8) d_ff=2048/expert vocab=163840, MoE 384
experts top-8.  First layer uses a dense FFN (as in the model card); the
remaining 60 MoE layers are scanned.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=163_840,
    head_dim=112,
    prefix_layers=("global",),
    block_pattern=("moe",),
    num_experts=384,
    experts_per_token=8,
    source="arXiv:2501.kimi2",
)

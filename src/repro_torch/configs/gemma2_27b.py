"""Gemma 2 27B [arXiv:2408.00118], as in
``repro.configs.gemma2_27b``.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000 — alternating
local/global attention (window 4096), attention + final-logit softcaps.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    d_ff=36864,
    vocab_size=256_000,
    head_dim=128,
    block_pattern=("local", "global"),
    sliding_window=4096,
    logit_softcap=30.0,
    attn_softcap=50.0,
    source="arXiv:2408.00118",
)

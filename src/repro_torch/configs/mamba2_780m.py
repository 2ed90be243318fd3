"""Mamba2-780m — SSD (state-space duality) [arXiv:2405.21060], as in
``repro.configs.mamba2_780m``.

48L d_model=1536 attention-free, vocab=50280, ssm_state=128.  d_ff=0: Mamba2
blocks subsume the FFN (expand factor 2).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=1,          # unused by mamba mixer
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50_280,
    block_pattern=("mamba",),
    ssm_state=128,
    tie_embeddings=True,
    source="arXiv:2405.21060",
)

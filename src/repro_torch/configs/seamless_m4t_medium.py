"""SeamlessM4T-medium [arXiv:2308.11596], as in
``repro.configs.seamless_m4t_medium``.

12L d_model=1024 16H (kv=16) d_ff=4096 vocab=256206, layernorm: an
encoder of 12 self-attention layers over (B, encoder_frames, d_model)
stub frame embeddings (the speech frontend is a stub), then 12 ``cross``
decoder layers over its output.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256_206,
    block_pattern=("cross",),
    encoder_layers=12,
    encoder_frames=1024,
    norm="layernorm",
    source="arXiv:2308.11596",
)

"""StarCoder2-3B [arXiv:2402.19173], as in
``repro.configs.starcoder2_3b``.

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152 — GQA + RoPE, native
sliding-window attention (4096) -> qualifies for long_500k decode.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49_152,
    block_pattern=("local",),
    sliding_window=4096,
    norm="layernorm",
    source="arXiv:2402.19173",
)

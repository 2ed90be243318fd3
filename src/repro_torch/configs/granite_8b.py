"""IBM Granite 8B code model [arXiv:2405.04324], as in
``repro.configs.granite_8b``.

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152: llama-arch, full
causal attention.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=49_152,
    block_pattern=("global",),
    source="arXiv:2405.04324",
)

"""Llama 3.2 Vision 11B [hf:meta-llama/Llama-3.2-11B-Vision], as in
``repro.configs.llama3p2_vision_11b``.

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256: the language
decoder with a ``cross`` layer (self-attention, cross-attention over the
image memory, MLP) every 5th layer.  The vision encoder is a stub: the
memory is (B, num_image_tokens, d_model) projected patch embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128_256,
    block_pattern=("global", "global", "global", "global", "cross"),
    num_image_tokens=1601,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)

"""Phi-3-Vision-128k (phi3-mini text backbone + CLIP stub frontend).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]

The vision tower is a STUB: input_specs() provides precomputed patch
embeddings (num_patches x d_model) prepended to the token stream.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="dense",
    modality="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    activation="swiglu",
    num_patches=256,
)

SMOKE = CONFIG.scaled(num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
                      head_dim=32, d_ff=256, vocab_size=256, num_patches=8)

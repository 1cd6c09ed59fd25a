"""MusicGen-large: decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

The EnCodec frontend is a STUB: input_specs() provides precomputed frame
embeddings (B, S, d_model); the head predicts the next codebook token
(vocab 2048).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="dense",
    modality="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    activation="swiglu",
    frame_embed=True,
)

SMOKE = CONFIG.scaled(num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
                      head_dim=32, d_ff=256, vocab_size=128)

"""Mistral-Large-Instruct-2407 (123B dense).
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    activation="swiglu",
    rope_theta=1_000_000.0,
)

SMOKE = CONFIG.scaled(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                      head_dim=32, d_ff=256, vocab_size=256)

"""Phi-3.5-MoE: 16 experts top-2. [hf:microsoft/Phi-3.5-MoE-instruct; hf]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    activation="swiglu",
    num_experts=16,
    experts_per_token=2,
    moe_d_ff=6400,
    capacity_factor=1.25,
)

SMOKE = CONFIG.scaled(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                      head_dim=32, d_ff=128, vocab_size=256, num_experts=4,
                      experts_per_token=2, moe_d_ff=128)

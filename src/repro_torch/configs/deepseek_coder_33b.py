"""DeepSeek-Coder-33B (llama-arch). [arXiv:2401.14196; hf]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    activation="swiglu",
    rope_theta=100_000.0,
)

SMOKE = CONFIG.scaled(num_layers=2, d_model=128, num_heads=8, num_kv_heads=2,
                      head_dim=16, d_ff=256, vocab_size=256)

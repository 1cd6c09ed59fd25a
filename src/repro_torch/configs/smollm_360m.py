"""SmolLM-360M (llama-arch small). [hf:HuggingFaceTB/SmolLM-135M; hf]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    activation="swiglu",
    tie_embeddings=True,
)

SMOKE = CONFIG.scaled(num_layers=2, d_model=96, num_heads=3, num_kv_heads=1,
                      head_dim=32, d_ff=192, vocab_size=256)

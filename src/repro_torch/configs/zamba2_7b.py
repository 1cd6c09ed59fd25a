"""Zamba2-7B: Mamba2 backbone + shared attention block every 6 layers.
[arXiv:2411.15242; unverified]

Adaptation notes (DESIGN.md SS4/SS6): the real model interleaves two
alternating shared blocks with per-slot LoRA deltas; we implement one
shared attention+MLP block (weights reused at every slot).  For
long_500k the shared-attention KV is windowed to 32768 positions — the
Mamba2 backbone carries the long-range state.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    activation="swiglu",
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    attn_every=6,
    attn_window=32768,
)

SMOKE = CONFIG.scaled(num_layers=4, d_model=128, num_heads=4, num_kv_heads=4,
                      head_dim=32, d_ff=256, vocab_size=256, ssm_state=16,
                      ssm_head_dim=32, ssm_chunk=16, attn_every=2,
                      attn_window=64)

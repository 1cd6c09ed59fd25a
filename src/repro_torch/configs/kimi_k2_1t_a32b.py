"""Kimi K2 — trillion-param MoE, 384 experts top-8 + 1 shared expert.
[arXiv:2501.kimi2; unverified, paper-table]

Adaptation note (DESIGN.md SS4): the public table lists GQA kv=8 with 64
heads at d_model=7168; we use an explicit head_dim=128 (MXU-aligned)
rather than 7168/64=112.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab_size=163840,
    activation="swiglu",
    num_experts=384,
    experts_per_token=8,
    moe_d_ff=2048,
    shared_expert_d_ff=2048,
    capacity_factor=1.25,
)

SMOKE = CONFIG.scaled(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                      head_dim=32, d_ff=64, vocab_size=512, num_experts=8,
                      experts_per_token=2, moe_d_ff=64, shared_expert_d_ff=64)

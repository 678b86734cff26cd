"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384 experts top-8 — trillion-param MoE (paper-table).
[arXiv:2501.kimi2; unverified]

The dense d_ff=2048 given in the assignment is the per-expert hidden dim;
one shared expert follows the DeepSeek-V3-style layout Kimi K2 inherits.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=2048,
    vocab_size=163_840,
    mlp_activation="swiglu",
    rope_theta=50_000.0,
    norm="rmsnorm",
    n_experts=384,
    n_experts_per_token=8,
    n_shared_experts=1,
    moe_d_ff=2048,
    capacity_factor=1.25,
)

SMOKE_CONFIG = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=64,
    vocab_size=256, n_experts=8, n_experts_per_token=2, moe_d_ff=64,
)

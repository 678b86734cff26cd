"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
ssm_state=16 — parallel attn+mamba heads, sliding-window attention (global
attention on a few layers is approximated by the window; meta-tokens omitted,
see DESIGN.md).  [arXiv:2411.13676; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32_001,
    mlp_activation="swiglu",
    rope_theta=10_000.0,
    norm="rmsnorm",
    ssm_state=16,
    sliding_window=2048,
)

SMOKE_CONFIG = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=5, n_kv_heads=1, d_ff=128, vocab_size=256,
    ssm_state=4, sliding_window=16,
)

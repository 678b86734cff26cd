"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536 —
Finch, data-dependent decay.  [arXiv:2404.05892; hf]

d_ff is realised inside the rwkv channel-mix (3.5x d_model = 8960).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=1,            # unused (attention-free)
    n_kv_heads=1,
    d_ff=8960,
    vocab_size=65_536,
    norm="layernorm",
    ssm_heads=40,         # 40 heads x 64 head dim
)

SMOKE_CONFIG = CONFIG.scaled(
    n_layers=2, d_model=64, d_ff=224, vocab_size=256, ssm_heads=4,
)

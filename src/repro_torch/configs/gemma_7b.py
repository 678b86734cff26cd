"""gemma-7b [dense]: 28L d_model=3072 16H (GQA kv=16) d_ff=24576
vocab=256000 — GeGLU, head_dim=256.  [arXiv:2403.08295; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24_576,
    vocab_size=256_000,
    mlp_activation="geglu",
    rope_theta=10_000.0,
    norm="rmsnorm",
    tie_embeddings=True,
    embed_scale=True,
)

SMOKE_CONFIG = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=192,
    vocab_size=256,
)

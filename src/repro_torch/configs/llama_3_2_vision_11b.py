"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attn image layers every 5th layer; the vision tower is a
STUB (callers give precomputed patch embeddings, ``image_embeds``).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=128_256,
    mlp_activation="swiglu",
    rope_theta=500_000.0,
    norm="rmsnorm",
    cross_attn_every=5,
    n_image_tokens=1601,   # 1 tile x (40x40 patches + 1 cls)
)

SMOKE_CONFIG = CONFIG.scaled(
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
    cross_attn_every=5, n_image_tokens=17,
)

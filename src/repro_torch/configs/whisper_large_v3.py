"""whisper-large-v3 [audio]: 32L d_model=1280 20H d_ff=5120 vocab=51866 —
enc-dec; the conv frontend is a STUB (callers give precomputed 1500-frame
embeddings, ``audio_frames``).  [arXiv:2212.04356; unverified]

As in the reference's config, RoPE replaces whisper's learned/sinusoidal
positional embeddings, in the encoder and the decoder.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51_866,
    mlp_activation="gelu",
    qkv_bias=True,
    rope_theta=10_000.0,
    norm="layernorm",
    encoder_layers=32,
    encoder_seq=1500,
)

SMOKE_CONFIG = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
    encoder_layers=2, encoder_seq=30,
)

"""Architecture configs (one module per architecture): the reference's ten.

The dense configs qwen1.5-0.5b, llama3.2-3b (grouped KV heads),
starcoder2-3b (a 4096-token sliding window, LayerNorm, QKV biases) and
gemma-7b (head dim 256, GeGLU, tied and scaled embeddings); the
mixture-of-experts qwen2-moe-a2.7b and kimi-k2-1t-a32b (384 experts, top
8, head dim 112); the vision model llama-3.2-vision-11b (gated image
cross-attention every 5th layer); the encoder-decoder whisper-large-v3;
the hybrid hymba-1.5b (attention and a Mamba mixer in parallel, a
2048-token window); and the attention-free rwkv6-3b.  ``shapes`` holds
the dry-run's four input shapes.

Beside them, outside ``ARCH_MODULES`` (the JAX package's ten, which the
parity tests hold the port to): ``kimi_k2_instruct``, Kimi-K2-Instruct as
its published config.json states it (latent attention, YaRN, a dense
first layer, a sigmoid router over 384 experts with a correction bias),
which ``kimi-k2-1t-a32b`` only guesses at; it has no JAX twin and is held
to the plain reference ``portbench/reference/moe.py``.
"""

from repro_torch.configs.shapes import SHAPES, InputShape, shapes_for
from repro_torch.configs import (gemma_7b, hymba_1_5b, kimi_k2_1t_a32b,
                                 llama3_2_3b, llama_3_2_vision_11b,
                                 qwen1_5_0_5b, qwen2_moe_a2_7b, rwkv6_3b,
                                 starcoder2_3b, whisper_large_v3)

ARCH_MODULES = {
    "llama3.2-3b": llama3_2_3b,
    "qwen1.5-0.5b": qwen1_5_0_5b,
    "starcoder2-3b": starcoder2_3b,
    "gemma-7b": gemma_7b,
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
    "llama-3.2-vision-11b": llama_3_2_vision_11b,
    "whisper-large-v3": whisper_large_v3,
    "hymba-1.5b": hymba_1_5b,
    "rwkv6-3b": rwkv6_3b,
}

CONFIGS = {name: mod.CONFIG for name, mod in ARCH_MODULES.items()}
SMOKE_CONFIGS = {name: mod.SMOKE_CONFIG for name, mod in ARCH_MODULES.items()}

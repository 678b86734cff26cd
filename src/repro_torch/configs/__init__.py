"""Architecture configs ported so far (one module per architecture).

The dense configs qwen1.5-0.5b and llama3.2-3b (the dense one with
grouped KV heads), the mixture-of-experts qwen2-moe-a2.7b, the vision
model llama-3.2-vision-11b (gated image cross-attention every 5th layer)
and the encoder-decoder whisper-large-v3.  The reference's other five
architectures and its ``shapes.py`` are still to be ported.
"""

from repro_torch.configs import (llama3_2_3b, llama_3_2_vision_11b,
                                 qwen1_5_0_5b, qwen2_moe_a2_7b,
                                 whisper_large_v3)

ARCH_MODULES = {
    "llama-3.2-vision-11b": llama_3_2_vision_11b,
    "llama3.2-3b": llama3_2_3b,
    "qwen1.5-0.5b": qwen1_5_0_5b,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
    "whisper-large-v3": whisper_large_v3,
}

CONFIGS = {name: mod.CONFIG for name, mod in ARCH_MODULES.items()}
SMOKE_CONFIGS = {name: mod.SMOKE_CONFIG for name, mod in ARCH_MODULES.items()}

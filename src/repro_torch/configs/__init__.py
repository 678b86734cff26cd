"""Architecture configs ported so far (one module per architecture).

The dense configs qwen1.5-0.5b and llama3.2-3b (the dense one with
grouped KV heads), and the mixture-of-experts qwen2-moe-a2.7b.  The
reference's other seven architectures and its ``shapes.py`` are still to
be ported.
"""

from repro_torch.configs import llama3_2_3b, qwen1_5_0_5b, qwen2_moe_a2_7b

ARCH_MODULES = {
    "llama3.2-3b": llama3_2_3b,
    "qwen1.5-0.5b": qwen1_5_0_5b,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
}

CONFIGS = {name: mod.CONFIG for name, mod in ARCH_MODULES.items()}
SMOKE_CONFIGS = {name: mod.SMOKE_CONFIG for name, mod in ARCH_MODULES.items()}

"""Architecture configs ported so far (one module per architecture).

The dense configs with a serving path on the card: qwen1.5-0.5b and
llama3.2-3b (the dense one with grouped KV heads).  The reference's other
eight architectures and its ``shapes.py`` are still to be ported.
"""

from repro_torch.configs import llama3_2_3b, qwen1_5_0_5b

ARCH_MODULES = {
    "llama3.2-3b": llama3_2_3b,
    "qwen1.5-0.5b": qwen1_5_0_5b,
}

CONFIGS = {name: mod.CONFIG for name, mod in ARCH_MODULES.items()}
SMOKE_CONFIGS = {name: mod.SMOKE_CONFIG for name, mod in ARCH_MODULES.items()}

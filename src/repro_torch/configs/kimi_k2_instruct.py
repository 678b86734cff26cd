"""kimi-k2-instruct [moe]: Kimi-K2-Instruct as published
(https://huggingface.co/moonshotai/Kimi-K2-Instruct/blob/main/config.json,
``model_type`` kimi_k2, DeepSeek-V3's layout): 61 layers, the first dense
(``intermediate_size`` 18432), d_model 7168, 64 heads of latent attention
(``q_lora_rank`` 1536, ``kv_lora_rank`` 512, q/k heads of 128 + 64 rotated,
v heads of 128), YaRN RoPE (base 50000, factor 32 over 4096 positions),
384 routed experts of width 2048 under a sigmoid router (top 8,
``routed_scaling_factor`` 2.827, a correction bias used only to choose),
one shared expert, vocabulary 163840, untied head.

Not in ``ARCH_MODULES``: that table is the JAX package's ten, of which
``kimi-k2-1t-a32b`` is the reference's guess at this model (grouped-query
attention, a softmax router with a capacity), kept for parity.  The rope
dims rotate as halves, where the published checkpoint interleaves them
(with random weights only a permutation of ``wq_b``'s and ``wkv_a``'s
columns).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-instruct",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=64,
    d_ff=18432,
    vocab_size=163_840,
    mlp_activation="swiglu",
    rope_theta=50_000.0,
    norm="rmsnorm",
    n_experts=384,
    router_experts=384,
    n_experts_per_token=8,
    n_shared_experts=1,
    moe_d_ff=2048,
    router_scoring="sigmoid",
    routed_scaling_factor=2.827,
    first_k_dense=1,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_scaling_factor=32.0,
    rope_original_max_len=4096,
    rope_beta_fast=1.0,
    rope_beta_slow=1.0,
    rope_mscale=1.0,
    rope_mscale_all_dim=1.0,
)

#: The same structure at CPU sizes: a dense block, then moe blocks; 8
#: routed experts, all held.
SMOKE_CONFIG = CONFIG.scaled(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
    vocab_size=256, n_experts=8, router_experts=8, n_experts_per_token=2,
    moe_d_ff=32, q_lora_rank=24, kv_lora_rank=16, qk_nope_head_dim=8,
    qk_rope_head_dim=8, v_head_dim=8, rope_original_max_len=64,
)

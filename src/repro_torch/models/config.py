"""Model configuration: the same fields as the reference's ``ModelConfig``.

``dtype`` and ``param_dtype`` stay strings (``"float32"``, ``"bfloat16"``)
and map to torch dtypes through :meth:`ModelConfig.activation_dtype` and
:meth:`ModelConfig.weight_dtype`.  ``attention_impl`` routes full-sequence
attention: ``"plain"`` (scores materialised in tensor code, the twin of
the reference's ``"xla"``) or ``"kernel"`` (the hand-written flash kernel
on a GPU and its plain version on the CPU, the twin of ``"pallas"`` and
``"pallas_interpret"``).

Kimi-K2-Instruct's fields (``configs/kimi_k2_instruct.py``; all off by
default, so every other configuration is as before):

* latent attention (MLA) where ``kv_lora_rank`` > 0: queries through a
  ``q_lora_rank`` bottleneck, keys and values expanded from a normalised
  ``kv_lora_rank`` latent, heads of ``qk_nope_head_dim + qk_rope_head_dim``
  for q and k and ``v_head_dim`` for v, one rotated key part shared by
  every head;
* YaRN RoPE where ``rope_scaling_factor`` > 1 (DeepSeek's form, with
  ``rope_original_max_len``, ``rope_beta_fast``, ``rope_beta_slow``,
  ``rope_mscale``, ``rope_mscale_all_dim``);
* ``first_k_dense`` leading blocks with a dense MLP of ``d_ff`` in a moe
  model, the rest with experts of ``moe_d_ff``;
* ``router_scoring`` "sigmoid": DeepSeek-V3's sigmoid router, a float32
  correction bias used only to choose, the chosen scores normalised and
  scaled by ``routed_scaling_factor``, and a dropless dispatch of the pairs
  that land on the experts held here: ``n_experts`` of them, numbered from
  ``expert_offset``, out of ``router_experts`` that the router scores
  (one chip's share under expert parallelism).
"""

from __future__ import annotations

import dataclasses
import math

import torch

ATTENTION_IMPLS = ("plain", "kernel")
ROUTER_SCORINGS = ("softmax", "sigmoid")
REMATS = ("none", "dots", "full")


def yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    """YaRN's attention temperature: ``0.1 * mscale * ln(factor) + 1``
    (1 where ``factor`` is at most 1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    mlp_activation: str = "swiglu"   # swiglu | geglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 500_000.0
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    embed_scale: bool = False    # gemma: scale embeddings by sqrt(d_model)
    # MoE
    n_experts: int = 0
    n_experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    router_scoring: str = "softmax"  # softmax (capacity) | sigmoid (dropless)
    router_experts: int = 0      # experts the router scores; 0 -> n_experts
    expert_offset: int = 0       # id of the first expert held here
    routed_scaling_factor: float = 1.0
    first_k_dense: int = 0       # leading blocks with a dense MLP of d_ff
    # latent attention (MLA); kv_lora_rank 0 -> grouped-query attention
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # YaRN; rope_scaling_factor 0 -> plain RoPE
    rope_scaling_factor: float = 0.0
    rope_original_max_len: int = 0
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 1.0
    rope_mscale_all_dim: float = 0.0
    # SSM / hybrid
    ssm_state: int = 0
    ssm_heads: int = 0
    sliding_window: int = 0      # 0 = full causal attention
    # VLM (cross-attention layers)
    cross_attn_every: int = 0
    n_image_tokens: int = 0
    # audio (encoder-decoder)
    encoder_layers: int = 0
    encoder_seq: int = 0
    # numerics / execution
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: str = "none"          # none | dots | full
    attention_impl: str = "plain"  # plain | kernel
    moe_dispatch: str = "scatter"
    scan_layers: bool = True

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl {self.attention_impl!r} not in "
                             f"{ATTENTION_IMPLS}")
        if self.remat not in REMATS:
            raise ValueError(f"remat {self.remat!r} not in {REMATS}")
        if self.router_scoring not in ROUTER_SCORINGS:
            raise ValueError(f"router_scoring {self.router_scoring!r} not in "
                             f"{ROUTER_SCORINGS}")
        if self.expert_offset + self.n_experts > self.resolved_router_experts:
            raise ValueError(
                f"experts {self.expert_offset}.."
                f"{self.expert_offset + self.n_experts - 1} past the "
                f"router's {self.resolved_router_experts}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_moe_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def resolved_router_experts(self) -> int:
        return self.router_experts or self.n_experts

    @property
    def mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def mla_softmax_scale(self) -> float:
        """MLA's softmax scale: the q/k head dim's ``-1/2`` power, times
        YaRN's ``mscale(factor, mscale_all_dim)`` squared."""
        scale = (self.qk_nope_head_dim + self.qk_rope_head_dim) ** -0.5
        if self.rope_scaling_factor > 1 and self.rope_mscale_all_dim:
            m = yarn_mscale(self.rope_scaling_factor, self.rope_mscale_all_dim)
            scale *= m * m
        return scale

    @property
    def resolved_ssm_heads(self) -> int:
        """RWKV6's heads: ``ssm_heads``, or one per 64 model dims."""
        return self.ssm_heads or max(self.d_model // 64, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve 500k-token contexts?  (An SSM state or a
        sliding window keeps the per-token cost O(1) in the context.)"""
        return self.family in ("ssm", "hybrid")

    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def weight_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def scaled(self, **overrides) -> "ModelConfig":
        """A reduced copy for smoke tests (same family/features)."""
        return dataclasses.replace(self, **overrides)


#: The fields the JAX package's ``ModelConfig`` lacks (Kimi-K2-Instruct's),
#: each with its default, under which it changes nothing.
PORT_ONLY = {f.name: f.default for f in dataclasses.fields(ModelConfig)
             if f.name in (
                 "router_scoring", "router_experts", "expert_offset",
                 "routed_scaling_factor", "first_k_dense", "q_lora_rank",
                 "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
                 "v_head_dim", "rope_scaling_factor", "rope_original_max_len",
                 "rope_beta_fast", "rope_beta_slow", "rope_mscale",
                 "rope_mscale_all_dim")}

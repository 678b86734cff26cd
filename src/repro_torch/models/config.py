"""Model configuration: the same fields as the reference's ``ModelConfig``.

``dtype`` and ``param_dtype`` stay strings (``"float32"``, ``"bfloat16"``)
and map to torch dtypes through :meth:`ModelConfig.activation_dtype` and
:meth:`ModelConfig.weight_dtype`.  ``attention_impl`` routes full-sequence
attention: ``"plain"`` (scores materialised in tensor code, the twin of
the reference's ``"xla"``) or ``"kernel"`` (the hand-written flash kernel
on a GPU and its plain version on the CPU, the twin of ``"pallas"`` and
``"pallas_interpret"``).
"""

from __future__ import annotations

import dataclasses

import torch

ATTENTION_IMPLS = ("plain", "kernel")
REMATS = ("none", "dots", "full")


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

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_moe_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

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

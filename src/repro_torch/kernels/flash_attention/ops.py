"""Public entry of the flash-attention kernel: device dispatch."""

from __future__ import annotations

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_plain


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    scale: float = None):
    """q: (B, Sq, Hq, D); k: (B, Skv, Hkv, D); v: (B, Skv, Hkv, Dv), Dv <= D
    -> (B, Sq, Hq, Dv); scores scaled by ``scale`` (``D ** -0.5`` when
    None).

    A CUDA tensor goes to the hand-written kernel, a CPU tensor to the
    plain torch version; there is no fallback between them.  Ragged
    lengths need no padding: both mask past Skv themselves.  A DTensor is
    refused on either device: the model hands each rank's local rows and
    heads (``sharding.local_heads``).
    """
    for name, t in (("q", q), ("k", k), ("v", v)):
        if hasattr(t, "placements"):
            raise TypeError(f"flash_attention: {name} is a DTensor; pass "
                            "each rank's local tensor (sharding.local_heads)")
    if q.device.type == "cuda":
        return kernel.flash_attention_cuda(q, k, v, causal, window, scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: no path for device {q.device}")
    return flash_attention_plain(q, k, v, causal, window, scale)

"""Plain torch version of the fused RMSNorm kernel.

:func:`rms_norm_plain` is the whole function the CUDA kernel computes: the
CPU path of :func:`repro_torch.kernels.rmsnorm.ops.rms_norm` and the
version the kernel is held against on the card.
"""

from __future__ import annotations

import torch


def rms_norm_plain(x, scale, eps: float = 1e-6):
    """x: (..., D); scale: (D,) -> x * rsqrt(mean(x^2) + eps) * scale in
    x's dtype, with float32 statistics."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)

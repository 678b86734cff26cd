"""Public entry of the RMSNorm kernel: device dispatch."""

from __future__ import annotations

from repro_torch.kernels.rmsnorm import kernel
from repro_torch.kernels.rmsnorm.ref import rms_norm_plain


def rms_norm(x, scale, eps: float = 1e-6):
    """x: (..., D) -> same shape and dtype; float32 statistics.

    A CUDA tensor goes to the hand-written kernel, a CPU tensor to the
    plain torch version; there is no fallback between them.
    """
    if x.device.type == "cuda":
        return kernel.rms_norm_cuda(x, scale, eps)
    if x.device.type != "cpu":
        raise ValueError(f"rms_norm: no path for device {x.device}")
    return rms_norm_plain(x, scale, eps)

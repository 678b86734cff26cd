"""Launch the hand-written CUDA RMSNorm kernel.

The source is ``csrc/rmsnorm.cu`` (a plain C entry, ``rmsnorm_launch``),
built and loaded by :mod:`repro_torch.kernels._build` at first use.
"""

from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels._build import FLOAT, INT, PTR, CudaLibrary, check_inputs

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"
LIB = CudaLibrary(SOURCE, {"rmsnorm_launch": (PTR, PTR, PTR, INT, INT, FLOAT,
                                              INT, PTR)})
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Launches of the CUDA kernel in this process; :func:`rms_norm_cuda` adds
#: one per launch and nothing else touches it.
LAUNCHES = 0


def rms_norm_cuda(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Launch the kernel: x (..., D) float32/bfloat16, scale (D,) float32,
    both CUDA and contiguous, D a multiple of 4 -> x's shape and dtype.
    Launches on the current stream and does not synchronise."""
    global LAUNCHES
    check_inputs("rms_norm_cuda", tuple(DTYPES), x=x)
    check_inputs("rms_norm_cuda", (torch.float32,), scale=scale)
    if scale.device != x.device:
        raise ValueError("rms_norm_cuda: x and scale on different devices")
    if x.dim() == 0 or tuple(scale.shape) != (x.shape[-1],):
        raise ValueError(f"rms_norm_cuda: x {tuple(x.shape)} and scale "
                         f"{tuple(scale.shape)} do not match")
    d = x.shape[-1]
    if d % 4:
        raise ValueError(f"rms_norm_cuda: last dim {d} is not a multiple of 4")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    LIB.launch("rmsnorm_launch", x.data_ptr(), scale.data_ptr(),
               out.data_ptr(), x.numel() // d, d, float(eps), DTYPES[x.dtype],
               stream)
    LAUNCHES += 1
    return out

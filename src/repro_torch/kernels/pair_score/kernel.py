"""Launch the hand-written CUDA ``pair_score`` kernel.

The source is ``csrc/pair_score.cu`` (a plain C entry,
``pair_score_launch``), built and loaded by :mod:`repro_torch.kernels._build`
at first use.
"""

from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels._build import BUILD_DIR, INT, NVCC_FLAGS, PTR, CudaLibrary

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "SOURCE", "LIB", "LAUNCHES",
           "library_path", "pair_score_cuda"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "pair_score.cu"
LIB = CudaLibrary(SOURCE, {"pair_score_launch": (PTR, PTR, PTR, INT, INT,
                                                 INT, PTR)})

#: Launches of the CUDA kernel in this process; :func:`pair_score_cuda`
#: adds one per launch and nothing else touches it.
LAUNCHES = 0

library_path = LIB.library_path


def pair_score_cuda(st: torch.Tensor, coeffs: torch.Tensor,
                    n_categories: int = 4, n_valid=None) -> torch.Tensor:
    """Launch the kernel: st (P, 4) f32 CUDA, coeffs (4, 4) f32 CUDA ->
    (P, P) f32 pair costs with ``DIAG`` on the diagonal and on rows/cols
    at or past ``n_valid`` (default P).  Launches on the current stream
    and does not synchronise."""
    global LAUNCHES
    for name, t in (("st", st), ("coeffs", coeffs)):
        if t.device.type != "cuda":
            raise ValueError(f"pair_score_cuda: {name} is on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"pair_score_cuda: {name} is {t.dtype}, not f32")
        if not t.is_contiguous():
            raise ValueError(f"pair_score_cuda: {name} is not contiguous")
    if st.dim() != 2 or st.shape[1] != 4:
        raise ValueError(f"pair_score_cuda: st must be (P, 4), got {tuple(st.shape)}")
    if tuple(coeffs.shape) != (4, 4):
        raise ValueError(
            f"pair_score_cuda: coeffs must be (4, 4), got {tuple(coeffs.shape)}")
    if coeffs.device != st.device:
        raise ValueError("pair_score_cuda: st and coeffs on different devices")
    if st.data_ptr() % 16:
        raise ValueError("pair_score_cuda: st must be 16-byte aligned")
    if not 1 <= n_categories <= 4:
        raise ValueError(f"pair_score_cuda: n_categories={n_categories}")
    p = st.shape[0]
    n_valid = p if n_valid is None else int(n_valid)
    out = torch.empty((p, p), dtype=torch.float32, device=st.device)
    stream = torch.cuda.current_stream(st.device).cuda_stream
    LIB.launch("pair_score_launch", st.data_ptr(), coeffs.data_ptr(),
               out.data_ptr(), p, n_valid, n_categories, stream)
    LAUNCHES += 1
    return out

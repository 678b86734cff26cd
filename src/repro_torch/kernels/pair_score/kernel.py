"""Launch the hand-written CUDA ``pair_score`` kernel.

The source is ``csrc/pair_score.cu`` (a plain C entry,
``pair_score_launch``), built and loaded by :mod:`repro_torch.kernels._build`
at first use.
"""

from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels._build import (
    BUILD_DIR, INT, NVCC_FLAGS, PTR, CudaLibrary, check_inputs)

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "SOURCE", "LIB", "LAUNCHES",
           "library_path", "pair_score_cuda"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "pair_score.cu"
LIB = CudaLibrary(SOURCE, {"pair_score_launch": (PTR, PTR, PTR, PTR, PTR, INT,
                                                 INT, INT, INT, INT, INT,
                                                 PTR)})

#: Launches of the CUDA kernel in this process; :func:`pair_score_cuda`
#: adds one per launch and nothing else touches it.
LAUNCHES = 0

library_path = LIB.library_path


def pair_score_cuda(st: torch.Tensor, coeffs: torch.Tensor,
                    n_categories: int = 4, n_valid=None, valid=None,
                    idle_row: int = -1, p=None,
                    idle_flag=None) -> torch.Tensor:
    """Launch the kernel: (p, p) f32 pair costs, ready for the matcher.

    ``st`` (rows, 4) f32 and ``coeffs`` (4, 4) f32 on one GPU; ``p``
    (default ``rows``) is the output size and ``n_valid`` (default
    ``min(rows, p)``) the count of leading vertices that may be valid;
    stack rows at or past ``n_valid`` are never read.  ``valid``: an
    optional (n_valid,) bool mask on the same GPU; ``idle_row``: the
    idle-context vertex, or -1; ``idle_flag``: an optional one-element
    bool tensor on the same GPU, read by the kernel: ``idle_row`` is the
    idle vertex only while it holds True (the host never reads it).
    Entry (i, j) is ``IDLE_COST`` when one
    side is the idle vertex and the other valid, else ``DIAG`` when i == j
    or either side is not valid, else the Eq. 4 cost (see
    :func:`repro_torch.kernels.pair_score.ref.pair_costs_plain`).

    Lanes: ``st`` (L, rows, 4) with ``valid`` (L, n_valid) and
    ``idle_flag`` (L,) scores L independent lanes in one launch and
    returns (L, p, p); each lane's slab is bit for bit the one-lane
    launch on that lane's inputs.  ``coeffs``, ``p``, ``n_valid`` and
    ``idle_row`` are shared.
    Launches on the current stream and does not synchronise."""
    global LAUNCHES
    check_inputs("pair_score_cuda", (torch.float32,), st=st, coeffs=coeffs)
    if st.dim() not in (2, 3) or st.shape[-1] != 4:
        raise ValueError(f"pair_score_cuda: st must be (rows, 4) or "
                         f"(lanes, rows, 4), got {tuple(st.shape)}")
    lane_shape = tuple(st.shape[:-2])
    lanes = st.shape[0] if lane_shape else 1
    if tuple(coeffs.shape) != (4, 4):
        raise ValueError(
            f"pair_score_cuda: coeffs must be (4, 4), got {tuple(coeffs.shape)}")
    if not 1 <= n_categories <= 4:
        raise ValueError(f"pair_score_cuda: n_categories={n_categories}")
    rows = st.shape[-2]
    p = rows if p is None else int(p)
    n_valid = min(rows, p) if n_valid is None else min(int(n_valid), p)
    if p < 0 or not 0 <= n_valid <= rows:
        raise ValueError(f"pair_score_cuda: p={p}, n_valid={n_valid} with "
                         f"{rows} stack rows")
    valid_ptr = None
    if valid is not None:
        if valid.device != st.device:
            raise ValueError(f"pair_score_cuda: valid is on {valid.device}, "
                             f"not {st.device}")
        if valid.dtype != torch.bool:
            raise TypeError(f"pair_score_cuda: valid is {valid.dtype}, not "
                            "torch.bool")
        if tuple(valid.shape) != lane_shape + (n_valid,) \
                or not valid.is_contiguous():
            raise ValueError(f"pair_score_cuda: valid must be a contiguous "
                             f"{lane_shape + (n_valid,)} mask, got "
                             f"{tuple(valid.shape)}")
        valid_ptr = valid.data_ptr()
    flag_ptr = None
    if idle_flag is not None:
        if idle_flag.device != st.device:
            raise ValueError(f"pair_score_cuda: idle_flag is on "
                             f"{idle_flag.device}, not {st.device}")
        if idle_flag.dtype != torch.bool or idle_flag.numel() != lanes \
                or not idle_flag.is_contiguous():
            raise TypeError(f"pair_score_cuda: idle_flag must be {lanes} "
                            f"contiguous torch.bool, got {idle_flag.dtype} "
                            f"{tuple(idle_flag.shape)}")
        flag_ptr = idle_flag.data_ptr()
    out = torch.empty(lane_shape + (p, p), dtype=torch.float32,
                      device=st.device)
    LIB.launch("pair_score_launch", st.data_ptr(), coeffs.data_ptr(),
               valid_ptr, flag_ptr, out.data_ptr(), p, n_valid, n_categories,
               int(idle_row), lanes, rows,
               torch.cuda.current_stream(st.device).cuda_stream)
    LAUNCHES += 1
    return out

"""Launch the hand-written CUDA decode-attention kernel.

The source is ``csrc/decode_attention.cu`` (a plain C entry,
``decode_attention_launch``), built and loaded by
:mod:`repro_torch.kernels._build` at first use.
"""

from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels._build import FLOAT, INT, PTR, CudaLibrary, check_inputs

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
LIB = CudaLibrary(SOURCE, {"decode_attention_launch": (
    PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, FLOAT, INT, PTR)})
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 8
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Launches of the CUDA kernel in this process;
#: :func:`decode_attention_cuda` adds one per launch and nothing else
#: touches it.
LAUNCHES = 0


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, lengths: torch.Tensor,
                          window: int = 0) -> torch.Tensor:
    """Launch the kernel: q (B, Hq, D), k/v_cache (B, S, Hkv, D) of one
    type (float32/bfloat16), lengths (B,) int32, all CUDA and contiguous
    -> (B, Hq, D) in q's dtype.  Launches on the current stream and does
    not synchronise."""
    global LAUNCHES
    check_inputs("decode_attention_cuda", (q.dtype,), q=q, k_cache=k_cache,
                 v_cache=v_cache)
    check_inputs("decode_attention_cuda", (torch.int32,), lengths=lengths)
    if q.dtype not in DTYPES:
        raise TypeError(f"decode_attention_cuda: q is {q.dtype}, not f32/bf16")
    if lengths.device != q.device:
        raise ValueError("decode_attention_cuda: lengths on another device")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError("decode_attention_cuda: q must be (B, Hq, D) and the "
                         "caches one (B, S, Hkv, D) shape; got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    b, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape[0] != b or k_cache.shape[3] != d or hkv == 0
            or hq % hkv or tuple(lengths.shape) != (b,)):
        raise ValueError(f"decode_attention_cuda: q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)} and lengths "
                         f"{tuple(lengths.shape)} do not match")
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention_cuda: head dim {d} not in {HEAD_DIMS}")
    if hq // hkv > MAX_GROUP:
        raise ValueError(f"decode_attention_cuda: {hq // hkv} query heads per "
                         f"KV head, at most {MAX_GROUP}")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    LIB.launch("decode_attention_launch", q.data_ptr(), k_cache.data_ptr(),
               v_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, s,
               hkv, hq // hkv, d, int(window), d ** -0.5, DTYPES[q.dtype],
               stream)
    LAUNCHES += 1
    return out

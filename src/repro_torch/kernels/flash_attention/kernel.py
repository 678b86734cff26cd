"""Launch the hand-written CUDA flash-attention kernel.

The source is ``csrc/flash_attention.cu`` (plain C entries:
``flash_attention_scratch`` sizes the scratch its float32 pre-pass
writes, ``flash_attention_launch`` launches the pre-pass and the
attention kernel), built and loaded by :mod:`repro_torch.kernels._build` at first
use.  The kernel has tiles for head dims 64, 128 and 256; any other head
dim up to 256 is zero-padded to the next tile (zero columns add nothing to
the scores and give zero output columns) and the output sliced back, with
the softmax scale taken from the true head dim unless one is given.  A v
head dim below q's and k's (latent attention's 128 under 192) is padded
to the same tile and the output sliced to it.
"""

from __future__ import annotations

from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels._build import FLOAT, INT, PTR, CudaLibrary, check_inputs

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
LIB = CudaLibrary(SOURCE, {
    "flash_attention_launch": (PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT,
                               INT, INT, INT, INT, FLOAT, INT, PTR),
    "flash_attention_scratch": (INT, INT, INT, INT, INT),
})
#: The kernel's head-dim tiles.
HEAD_DIMS = (64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Launches of the CUDA kernel in this process;
#: :func:`flash_attention_cuda` adds one per launch and nothing else
#: touches it.  ``NONCAUSAL_LAUNCHES`` counts those of them made with
#: ``causal=False`` (an encoder's).
LAUNCHES = 0
NONCAUSAL_LAUNCHES = 0


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int = 0,
                         scale: float = None) -> torch.Tensor:
    """Launch the kernel: q (B, Sq, Hq, D), k (B, Skv, Hkv, D), v (B, Skv,
    Hkv, Dv) with Dv <= D, all CUDA, contiguous, one of float32/bfloat16, D
    at most 256 -> (B, Sq, Hq, Dv) in q's dtype; scores scaled by ``scale``
    (``D ** -0.5`` when None).  A D that is not a tile's, or a Dv below D,
    goes through zero-padded copies.  Launches on the current stream and
    does not synchronise."""
    global LAUNCHES, NONCAUSAL_LAUNCHES
    check_inputs("flash_attention_cuda", (q.dtype,), q=q, k=k, v=v)
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention_cuda: q is {q.dtype}, not f32/bf16")
    if (q.dim() != 4 or k.dim() != 4 or v.dim() != 4
            or k.shape[:3] != v.shape[:3] or v.shape[3] > k.shape[3]):
        raise ValueError(
            "flash_attention_cuda: q must be (B, Sq, Hq, D), k (B, Skv, Hkv, "
            f"D) and v (B, Skv, Hkv, Dv <= D); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not match")
    if not 0 < d <= HEAD_DIMS[-1]:
        raise ValueError(f"flash_attention_cuda: head dim {d} not in 1.."
                         f"{HEAD_DIMS[-1]}")
    dv = v.shape[3]
    tile = next(t for t in HEAD_DIMS if t >= d)
    if tile != d:
        q, k = (F.pad(t, (0, tile - d)) for t in (q, k))
    if tile != dv:
        v = F.pad(v, (0, tile - dv))
    out = torch.empty_like(q)
    # For float32 the kernel's pre-pass writes K and V, split into TF32
    # hi/lo planes in the layout its tensor-core products read, into this
    # scratch; bfloat16 needs none.
    units = LIB.call("flash_attention_scratch", b, skv, hkv, tile,
                     DTYPES[q.dtype])
    scratch = torch.empty(16 * max(units, 1), dtype=torch.float32,
                          device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    LIB.launch("flash_attention_launch", q.data_ptr(), k.data_ptr(),
               v.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, sq, skv,
               hq, hkv, tile, int(bool(causal)), int(window),
               d ** -0.5 if scale is None else float(scale),
               DTYPES[q.dtype], stream)
    LAUNCHES += 1
    NONCAUSAL_LAUNCHES += int(not causal)
    return out if tile == dv else out[..., :dv].contiguous()

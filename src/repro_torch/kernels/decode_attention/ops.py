"""Public entry of the decode-attention kernel: device dispatch."""

from __future__ import annotations

from repro_torch.kernels.decode_attention import kernel
from repro_torch.kernels.decode_attention.ref import decode_attention_plain


def decode_attention(q, k_cache, v_cache, lengths, window: int = 0):
    """q: (B, Hq, D); k/v_cache: (B, S, Hkv, D); lengths: (B,) int32 ->
    (B, Hq, D); positions ``[0, len]`` are valid, inclusive.

    A CUDA tensor goes to the hand-written kernel, a CPU tensor to the
    plain torch version; there is no fallback between them.  The cache
    needs no padding: the kernel reads only the valid span.
    """
    if q.device.type == "cuda":
        return kernel.decode_attention_cuda(q, k_cache, v_cache, lengths,
                                            window)
    if q.device.type != "cpu":
        raise ValueError(f"decode_attention: no path for device {q.device}")
    return decode_attention_plain(q, k_cache, v_cache, lengths, window)

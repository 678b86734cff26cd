"""Plain torch version of the one-token decode-attention kernel.

:func:`decode_attention_plain` is the whole function the CUDA kernel
computes: the CPU path of
:func:`repro_torch.kernels.decode_attention.ops.decode_attention` and the
version the kernel is held against on the card.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_plain(q, k_cache, v_cache, lengths, window: int = 0):
    """q: (B, Hq, D), one query per sequence; k/v_cache: (B, S, Hkv, D);
    lengths: (B,) integer — positions ``[0, len]`` are valid, inclusive,
    and with ``window > 0`` only those past ``len - window``.

    Returns (B, Hq, D) in q's dtype; a row with no valid position is 0.
    Scores, softmax and the product with v are float32.
    """
    b, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    qg = q.float().reshape(b, hkv, group, d)
    scores = torch.einsum("bkgh,bskh->bkgs", qg,
                          k_cache.float()) * (d ** -0.5)
    length = lengths.to(device=q.device, dtype=torch.int64)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    valid = kpos <= length
    if window > 0:
        valid &= kpos > length - window
    valid = valid[:, None, None, :]
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1) * valid.any(-1, keepdim=True)
    out = torch.einsum("bkgs,bskh->bkgh", probs, v_cache.float())
    return out.reshape(b, hq, d).to(q.dtype)

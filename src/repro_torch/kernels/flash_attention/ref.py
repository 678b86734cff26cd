"""Plain torch version of the prefill flash-attention kernel.

:func:`flash_attention_plain` is the whole function the CUDA kernel
computes: the CPU path of
:func:`repro_torch.kernels.flash_attention.ops.flash_attention` and the
version the kernel is held against on the card.  It materialises the
(Sq, Skv) scores.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_plain(q, k, v, causal: bool = True, window: int = 0,
                          scale: float = None):
    """q: (B, Sq, Hq, D); k: (B, Skv, Hkv, D); v: (B, Skv, Hkv, Dv) with Hq
    % Hkv == 0 -> (B, Sq, Hq, Dv) in q's dtype; scores scaled by ``scale``
    (``D ** -0.5`` when None).

    Query head h reads KV head ``h // (Hq // Hkv)``.  Key j is seen by
    query row i when ``j <= i`` (causal) and ``j > i - window``
    (``window > 0``); a row that sees no key is 0.  Scores, softmax and
    the product with v are float32.
    """
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    qg = q.float().reshape(b, sq, hkv, group, d)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * (
        d ** -0.5 if scale is None else scale)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1) * mask.any(-1, keepdim=True)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(b, sq, hq, v.shape[-1]).to(q.dtype)

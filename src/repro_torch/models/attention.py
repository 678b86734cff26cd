"""Attention: GQA/MQA/MHA with RoPE, causal and sliding-window masks,
cross-attention, and single-token decode against a KV cache.

Full-sequence attention (prefill) routes on ``cfg.attention_impl``:
``"kernel"`` goes through :func:`repro_torch.kernels.flash_attention.ops.
flash_attention` (the hand-written kernel on a GPU), ``"plain"`` through
:func:`_sdpa`, which materialises the scores; over DTensors both run on
each device's own rows and heads (``sharding.local_heads``).
Cross-attention and decode attend with plain tensor code whatever the
route, as the reference does.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dot, param, truncated_normal_
from repro_torch.sharding import local_heads, put_rows, reshape, shard

F32 = torch.float32
NEG_INF = -1e30


class Attention(nn.Module):
    """Projections in the reference's layouts: ``wq`` (d, H, hd), ``wk`` and
    ``wv`` (d, Hkv, hd), ``wo`` (H, hd, d), biases (H or Hkv, hd)."""

    def __init__(self, cfg: ModelConfig, d_model: Optional[int] = None,
                 device=None):
        super().__init__()
        d = d_model or cfg.d_model
        hd = cfg.resolved_head_dim
        wdt = cfg.weight_dtype()
        self.wq = param((d, cfg.n_heads, hd), wdt, device)
        self.wk = param((d, cfg.n_kv_heads, hd), wdt, device)
        self.wv = param((d, cfg.n_kv_heads, hd), wdt, device)
        self.wo = param((cfg.n_heads, hd, d), wdt, device)
        if cfg.qkv_bias:
            self.bq = param((cfg.n_heads, hd), wdt, device)
            self.bk = param((cfg.n_kv_heads, hd), wdt, device)
            self.bv = param((cfg.n_kv_heads, hd), wdt, device)
        else:
            self.bq = self.bk = self.bv = None

    def reset_parameters(self, generator) -> None:
        d = self.wq.shape[0]
        n_heads, hd = self.wo.shape[:2]
        for w in (self.wq, self.wk, self.wv):
            truncated_normal_(w, d ** -0.5, generator)
        truncated_normal_(self.wo, (n_heads * hd) ** -0.5, generator)
        with torch.no_grad():
            for b in (self.bq, self.bk, self.bv):
                if b is not None:
                    b.zero_()


def init_attention(cfg: ModelConfig, generator: torch.Generator, device=None,
                   d_model: Optional[int] = None) -> Attention:
    attn = Attention(cfg, d_model, device)
    attn.reset_parameters(generator)
    return attn


def _project_qkv(params: Attention, x, cfg: ModelConfig):
    """x (B, S, d) -> q (B, S, H, hd), k and v (B, S, Hkv, hd) in x's dtype;
    biases are added in float32 before the cast."""
    b, s, d = x.shape

    def proj(w, bias):
        y = reshape(dot(x, reshape(w, d, -1)), b, s, *w.shape[1:])
        if bias is not None:
            y = y + bias.float()
        return y.to(x.dtype)

    return (proj(params.wq, params.bq), proj(params.wk, params.bk),
            proj(params.wv, params.bv))


def _out_proj(params: Attention, out, dtype):
    """The output projection, its sum over the heads completed on every
    device of a mesh (an all-reduce where the heads are sharded)."""
    b, s = out.shape[:2]
    wo = reshape(params.wo, -1, params.wo.shape[-1])
    y = dot(reshape(out, b, s, -1), wo)
    return shard(y.to(dtype), "batch", None, "embed")


def _mask(q_len: int, kv_len: int, causal: bool, window: int, device=None):
    """(q_len, kv_len) boolean mask; True = attend."""
    qpos = torch.arange(q_len, device=device)[:, None]
    kpos = torch.arange(kv_len, device=device)[None, :]
    m = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m


def _sdpa(q, k, v, mask, cfg: ModelConfig):
    """Grouped scaled-dot-product attention with materialised scores.

    q: (B, Sq, Hq, hd); k/v: (B, Skv, Hkv, hd); mask: (Sq, Skv) or None.
    Over DTensors it runs on each device's rows and heads
    (:func:`repro_torch.sharding.local_heads`).
    """
    if mask is None:
        return local_heads(lambda q, k, v: _sdpa_core(q, k, v, None),
                           (q, k, v))
    return local_heads(_sdpa_core, (q, k, v), shared=(mask,))


def _sdpa_core(q, k, v, mask):
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    qg = reshape(q, b, sq, hkv, group, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    scores = scores * (hd ** -0.5)
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype).float(),
                       v.float())
    return reshape(out, b, sq, hq, hd).to(v.dtype)


def attention(params: Attention, x, cfg: ModelConfig, positions=None,
              causal: bool = True, rope: bool = True) -> torch.Tensor:
    """Full-sequence self-attention (training / prefill)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg)
    if rope:
        pos = (positions if positions is not None
               else torch.arange(s, device=x.device)[None, :])
        cos, sin = layers.rope_angles(pos, cfg.resolved_head_dim,
                                      cfg.rope_theta)
        q = layers.apply_rope(q, cos, sin)
        k = layers.apply_rope(k, cos, sin)
    q = shard(q, "batch", None, "heads", None)
    k = shard(k, "batch", None, "kv_heads", None)
    v = shard(v, "batch", None, "kv_heads", None)
    if cfg.attention_impl == "kernel":
        # The kernel takes plain tensors: over DTensors, each device's own
        # rows and heads.
        out = local_heads(functools.partial(
            fa_ops.flash_attention, causal=causal, window=cfg.sliding_window),
            (q, k, v))
    else:
        mask = _mask(s, s, causal, cfg.sliding_window, device=x.device)
        out = _sdpa(q, k, v, mask, cfg)
    out = shard(out, "batch", None, "heads", None)
    return _out_proj(params, out, x.dtype)


def cross_attention(params: Attention, x, kv_src, cfg: ModelConfig
                    ) -> torch.Tensor:
    """Cross-attention: queries from ``x`` (B, S, d), keys and values from
    ``kv_src`` (B, T, d) (image patch embeddings or the audio encoder's
    output).  No RoPE, no mask and no QKV biases (the reference projects
    with bare products), and always :func:`_sdpa`."""
    def proj(src, w):
        b, t, d = src.shape
        return reshape(dot(src, reshape(w, d, -1)), b, t, *w.shape[1:]
                       ).to(x.dtype)

    q = proj(x, params.wq)
    k, v = proj(kv_src, params.wk), proj(kv_src, params.wv)
    return _out_proj(params, _sdpa(q, k, v, None, cfg), x.dtype)


# ------------------------------------------------------------------ decode
def decode_attention(
    params: Attention,
    x,
    k_cache,
    v_cache,
    pos,
    cfg: ModelConfig,
    rope: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode step with per-sequence positions.

    x: (B, 1, d); k_cache/v_cache: (B, max_len, Hkv, hd); pos: (B,) integer,
    each sequence's current length (write index).  The new key and value
    are written into the caches **in place** at ``pos`` (a position at or
    past ``max_len`` writes nothing, as the reference's dropped
    out-of-bounds update), then every position ``<= pos`` is attended: a
    freshly reset slot (pos = 0) masks out every stale entry.  Returns
    ``(y, k_cache, v_cache)`` with the same cache tensors.
    """
    b, one, _ = x.shape
    if one != 1:
        raise ValueError(f"decode_attention takes one token, got {one}")
    max_len = k_cache.shape[1]
    pos = torch.as_tensor(pos, device=x.device).reshape(b).long()
    q, k, v = _project_qkv(params, x, cfg)
    if rope:
        cos, sin = layers.rope_angles(pos[:, None], cfg.resolved_head_dim,
                                      cfg.rope_theta)
        q = layers.apply_rope(q, cos, sin)
        k = layers.apply_rope(k, cos, sin)
    slot = pos.clamp(max=max_len - 1)
    for cache, new in ((k_cache, k), (v_cache, v)):
        put_rows(cache, slot, new[:, 0].to(cache.dtype), keep=pos < max_len)

    kpos = torch.arange(max_len, device=x.device)[None, :]
    valid = kpos <= pos[:, None]
    if cfg.sliding_window > 0:
        valid = valid & (kpos > (pos[:, None] - cfg.sliding_window))
    out = local_heads(decode_core, (q, k_cache, v_cache), rows=(valid,))
    return _out_proj(params, out, x.dtype), k_cache, v_cache


def decode_core(q, k_cache, v_cache, valid):
    """One query token q (B, 1, Hq, hd) against a cache (B, S, Hkv, hd),
    attending the slots where ``valid`` (B, S) holds -> (B, 1, Hq, hd) in
    q's dtype."""
    b, _, hq, hd = q.shape
    hkv = k_cache.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg.float(),
                          k_cache.float()) * (hd ** -0.5)
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", probs.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, hq, hd).to(q.dtype)

"""Attention: GQA/MQA/MHA with RoPE, causal and sliding-window masks,
cross-attention, and single-token decode against a KV cache.

Full-sequence attention (prefill) routes on ``cfg.attention_impl``:
``"kernel"`` goes through :func:`repro_torch.kernels.flash_attention.ops.
flash_attention` (the hand-written kernel on a GPU), ``"plain"`` through
:func:`_sdpa`, which materialises the scores; over DTensors both run on
each device's own rows and heads (``sharding.local_heads``).
Cross-attention and decode attend with plain tensor code whatever the
route, as the reference does.

Latent attention (MLA, :class:`MLA`, where ``cfg.kv_lora_rank`` > 0) has
two forms.  Prefill (:func:`mla_attention`) expands the normalised latent
into every head's keys and values and attends through the same route,
q/k heads of ``qk_nope_head_dim + qk_rope_head_dim`` and v heads of
``v_head_dim`` with ``cfg.mla_softmax_scale``; it can write the latent
and the rotated key part into a decode cache.  Decode
(:func:`mla_decode`) is absorbed: each head's query is carried into the
latent space through the key up-projection, attends the cached latents
and rotated key parts, and its read-out of the latents goes through the
value up-projection.  ``MLA_PREFILL`` and ``MLA_DECODE`` count the calls;
the spans ``mla.prefill`` and ``mla.decode`` enclose them.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_plain
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig, yarn_mscale
from repro_torch.models.layers import dot, param, truncated_normal_
from repro_torch.obs import trace as obs_trace
from repro_torch.sharding import local_heads, put_rows, reshape, shard

F32 = torch.float32
NEG_INF = -1e30

#: MLA calls in this process: :func:`mla_attention` and :func:`mla_decode`
#: add one a call (one a layer) and nothing else touches them.
MLA_PREFILL = 0
MLA_DECODE = 0


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


# ------------------------------------------------------ latent attention
class MLA(nn.Module):
    """Latent attention's projections (DeepSeek-V3's): ``wq_a`` (d, Rq)
    into the query latent, normalised by ``q_norm``, ``wq_b`` (Rq, H, Dn +
    Dr) out of it; ``wkv_a`` (d, Rkv + Dr) into the key-value latent
    (normalised by ``kv_norm``) and the shared rotated key part, ``wkv_b``
    (Rkv, H, Dn + Dv) out of the latent into each head's key part and
    value; ``wo`` (H, Dv, d)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, h, wdt = cfg.d_model, cfg.n_heads, cfg.weight_dtype()
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        self.wq_a = param((d, cfg.q_lora_rank), wdt, device)
        self.q_norm = layers.Norm(cfg.q_lora_rank, device)
        self.wq_b = param((cfg.q_lora_rank, h, dn + dr), wdt, device)
        self.wkv_a = param((d, cfg.kv_lora_rank + dr), wdt, device)
        self.kv_norm = layers.Norm(cfg.kv_lora_rank, device)
        self.wkv_b = param((cfg.kv_lora_rank, h, dn + dv), wdt, device)
        self.wo = param((h, dv, d), wdt, device)

    def reset_parameters(self, generator) -> None:
        for w in (self.wq_a, self.wq_b, self.wkv_a, self.wkv_b):
            truncated_normal_(w, w.shape[0] ** -0.5, generator)
        truncated_normal_(self.wo, (self.wo.shape[0] * self.wo.shape[1])
                          ** -0.5, generator)
        self.q_norm.reset_parameters()
        self.kv_norm.reset_parameters()


def yarn_inv_freq(cfg: ModelConfig, device=None) -> torch.Tensor:
    """The rotated dims' frequencies (Dr / 2,), float32: ``rope_theta``'s
    plain ones, or with YaRN (``rope_scaling_factor`` > 1, DeepSeek's
    form) a linear ramp over the correction range from the plain ones
    (extrapolated) down to them over the factor (interpolated)."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    plain = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=F32,
                                         device=device) / dim))
    factor = cfg.rope_scaling_factor
    if factor <= 1:
        return plain

    def correction_dim(rotations):
        return (dim * math.log(cfg.rope_original_max_len
                               / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(correction_dim(cfg.rope_beta_fast)), 0)
    high = min(math.ceil(correction_dim(cfg.rope_beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=F32, device=device) - low)
            / (high - low)).clamp(0, 1)
    return plain * (1 - ramp) + plain / factor * ramp


def yarn_angles(positions, cfg: ModelConfig):
    """positions (..., S) integer -> (cos, sin) (..., S, Dr / 2), each
    times YaRN's ``mscale(factor, mscale) / mscale(factor,
    mscale_all_dim)``."""
    ang = positions.to(F32)[..., None] * yarn_inv_freq(cfg, positions.device)
    m = 1.0
    if cfg.rope_scaling_factor > 1:
        m = (yarn_mscale(cfg.rope_scaling_factor, cfg.rope_mscale)
             / yarn_mscale(cfg.rope_scaling_factor, cfg.rope_mscale_all_dim))
    return torch.cos(ang) * m, torch.sin(ang) * m


def _mla_project(params: MLA, x, cfg: ModelConfig, cos, sin):
    """x (B, S, d) -> q (B, S, H, Dn + Dr) with its rotated part rotated,
    the normalised latent c_kv (B, S, Rkv) and the rotated key part k_pe
    (B, S, Dr), all in x's dtype."""
    b, s, d = x.shape
    dt, r = x.dtype, cfg.kv_lora_rank
    dn = cfg.qk_nope_head_dim
    c_q = layers.rms_norm(dot(x, params.wq_a), params.q_norm.scale).to(dt)
    q = dot(c_q, params.wq_b.reshape(cfg.q_lora_rank, -1)).reshape(
        b, s, cfg.n_heads, -1).to(dt)
    q = torch.cat([q[..., :dn], layers.apply_rope(q[..., dn:], cos, sin)], -1)
    kv_a = dot(x, params.wkv_a)
    c_kv = layers.rms_norm(kv_a[..., :r], params.kv_norm.scale).to(dt)
    k_pe = layers.apply_rope(kv_a[..., None, r:].to(dt), cos, sin)[:, :, 0]
    return q, c_kv, k_pe


def mla_attention(params: MLA, x, cfg: ModelConfig, latent=None
                  ) -> torch.Tensor:
    """Full-sequence causal latent attention at positions 0..S-1 (prefill).

    The latent is expanded into every head's key part and value (``wkv_b``)
    and the rotated key part joined to each head's; attention runs on
    ``cfg.attention_impl``'s route (the flash kernel on a GPU) with q/k
    heads of Dn + Dr, v heads of Dv and ``cfg.mla_softmax_scale``.  With
    ``latent`` = (c_cache, pe_cache), (B, >= S, Rkv) and (B, >= S, Dr), the
    normalised latents and rotated key parts are written into their first
    S rows, as :func:`mla_decode` reads them."""
    global MLA_PREFILL
    MLA_PREFILL += 1
    with obs_trace.span("mla.prefill"):
        b, s, _ = x.shape
        dn, h = cfg.qk_nope_head_dim, cfg.n_heads
        cos, sin = yarn_angles(torch.arange(s, device=x.device)[None, :], cfg)
        q, c_kv, k_pe = _mla_project(params, x, cfg, cos, sin)
        if latent is not None:
            latent[0][:, :s] = c_kv
            latent[1][:, :s] = k_pe
        kv = dot(c_kv, params.wkv_b.reshape(cfg.kv_lora_rank, -1)).reshape(
            b, s, h, -1).to(x.dtype)
        k = torch.cat([kv[..., :dn],
                       k_pe[:, :, None].expand(b, s, h, k_pe.shape[-1])], -1)
        v = kv[..., dn:]
        attend = (fa_ops.flash_attention if cfg.attention_impl == "kernel"
                  else flash_attention_plain)
        out = attend(q, k, v.contiguous(), causal=True,
                     scale=cfg.mla_softmax_scale)
        return _out_proj(params, out, x.dtype)


def mla_decode(params: MLA, x, c_cache, pe_cache, pos, cfg: ModelConfig
               ) -> torch.Tensor:
    """One-token absorbed latent attention with per-sequence positions.

    x: (B, 1, d); c_cache (B, max_len, Rkv) and pe_cache (B, max_len, Dr),
    the normalised latents and rotated key parts; pos: (B,) each
    sequence's length (write index).  The new token's latent and key part
    are written in place at ``pos`` (nothing at or past ``max_len``), then
    every position ``<= pos`` is attended in the latent space: scores
    ``(q_nope W_uk^T) . c + q_pe . k_pe``, values ``W_uv`` applied to the
    probabilities' read-out of the latents, all in float32.  Returns y
    (B, 1, d)."""
    global MLA_DECODE
    MLA_DECODE += 1
    with obs_trace.span("mla.decode"):
        b = x.shape[0]
        dn, r = cfg.qk_nope_head_dim, cfg.kv_lora_rank
        max_len = c_cache.shape[1]
        pos = torch.as_tensor(pos, device=x.device).reshape(b).long()
        cos, sin = yarn_angles(pos[:, None], cfg)
        q, c_kv, k_pe = _mla_project(params, x, cfg, cos, sin)
        slot = pos.clamp(max=max_len - 1)
        keep = pos < max_len
        put_rows(c_cache, slot, c_kv[:, 0].to(c_cache.dtype), keep=keep)
        put_rows(pe_cache, slot, k_pe[:, 0].to(pe_cache.dtype), keep=keep)
        w_uk = params.wkv_b[..., :dn].float()          # (Rkv, H, Dn)
        w_uv = params.wkv_b[..., dn:].float()          # (Rkv, H, Dv)
        q_lat = torch.einsum("bhn,rhn->bhr", q[:, 0, :, :dn].float(), w_uk)
        scores = (torch.einsum("bhr,bsr->bhs", q_lat, c_cache.float())
                  + torch.einsum("bhp,bsp->bhs", q[:, 0, :, dn:].float(),
                                 pe_cache.float())) * cfg.mla_softmax_scale
        valid = torch.arange(max_len, device=x.device)[None, :] <= pos[:, None]
        scores = scores.masked_fill(~valid[:, None, :], NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        o_lat = torch.einsum("bhs,bsr->bhr", probs, c_cache.float())
        out = torch.einsum("bhr,rhv->bhv", o_lat, w_uv).to(x.dtype)
        return _out_proj(params, out[:, None], x.dtype)

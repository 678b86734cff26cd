"""Model assembly: the dense, moe, vlm, audio, hybrid and ssm families.

One :class:`Model` (an ``nn.Module``) per architecture, built from a
:class:`ModelConfig`:

* ``Model(cfg, device)`` then ``init_weights(generator)`` -> parameters in
  the module (each stacked group of the reference a ``ModuleList``, one
  entry per layer);
* ``forward(batch)``               -> (logits, aux), full sequence
                                      (training / prefill);
* ``init_cache(batch, max_len)``   -> decode cache;
* ``decode_step(cache, tokens)``   -> (logits, cache), one new token.

Families:

    dense   pre-norm blocks: ``x += attn(n(x)); x += ffn(n(x))``, the
            feed-forward an MLP
    moe     the MLP replaced by routed experts plus shared ones (the
            blocks also return the load-balance loss); Kimi-K2's form
            adds latent attention (a latent decode cache) and dense first
            blocks
    vlm     every ``cross_attn_every``-th block is an extra gated image
            cross-attention block (Llama-3.2-Vision style) over
            precomputed patch embeddings (``batch["image_embeds"]``)
    audio   whisper-style encoder-decoder: a non-causal encoder over
            precomputed frame embeddings (``batch["audio_frames"]``), and
            decoder blocks of self-attention, gated cross-attention to the
            encoder's output, MLP
    hybrid  hymba: attention and a Mamba mixer (``models/ssm.py``) run in
            parallel on the same normalised input, their outputs averaged
    ssm     rwkv6: attention-free, a time-mix then a channel-mix

A cross block adds ``tanh(gate)`` times its cross-attention, ``gate`` a
float32 scalar that starts at 0.  ``cfg.remat`` recomputes each block (a
vlm group, a decoder block with its cross block) in the backward pass:
``"full"`` keeps nothing, ``"dots"`` keeps the products' outputs,
``"none"`` keeps everything; all three give the same numbers.

A sliding window that fits the decode cache makes the cache a ring buffer
of ``window`` slots (:func:`_ring_decode_attention`, dense, moe and
hybrid); the vlm and audio decoders attend through ``decode_attention``
whatever the window, as the reference's.  Mamba and RWKV states are
float32 and O(1) in the context length.  A decode step writes K, V and
the recurrent states into the cache's tensors in place (over a mesh, each
rank its own part: ``sharding.put_rows``, ``sharding.assign``).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import (assign, current_mesh, distribute_cache,
                                  local_heads, put_rows, shard)
from repro_torch.sharding.plan import STACKED

F32 = torch.float32
FAMILIES = ("dense", "moe", "vlm", "audio", "hybrid", "ssm")

#: The operators whose outputs ``remat="dots"`` keeps: the products.
_PRODUCTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
             torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, mode: str, *args):
    """``fn(*args)``, recomputed in the backward pass as ``mode`` says."""
    if mode == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if mode == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=functools.
                      partial(create_selective_checkpoint_contexts,
                              _dots_policy))


def reference_ndim(name: str, p: torch.Tensor) -> int:
    """The rank parameter ``name`` has in the reference's tree, where every
    parameter of a stacked group (:data:`STACKED`) has a leading layer
    axis."""
    return p.dim() + int(name.split(".", 1)[0] in STACKED)


class Block(nn.Module):
    """Norms ``ln1``, ``ln2``; for ssm an ``rwkv`` mixer alone, else
    ``attn`` (latent attention where ``cfg.mla``), for hybrid a Mamba
    ``ssm`` beside it, and ``moe`` or ``mlp`` (``mlp`` in a moe model's
    first ``cfg.first_k_dense`` blocks, ``layer`` the block's index)."""

    def __init__(self, cfg: ModelConfig, device=None, layer: int = 0):
        super().__init__()
        self.cfg = cfg
        self.ln1 = layers.Norm(cfg.d_model, device)
        self.ln2 = layers.Norm(cfg.d_model, device)
        self.attn = self.ssm = self.rwkv = self.moe = self.mlp = None
        if cfg.family == "ssm":
            self.rwkv = ssm_mod.RWKV6(cfg, device)
            return
        self.attn = (attn_mod.MLA(cfg, device) if cfg.mla
                     else attn_mod.Attention(cfg, device=device))
        if cfg.family == "hybrid":
            self.ssm = ssm_mod.Mamba(cfg, device=device)
        if cfg.family == "moe" and layer >= cfg.first_k_dense:
            self.moe = moe_mod.MoE(cfg, device)
        else:
            self.mlp = layers.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_activation,
                                  cfg.weight_dtype(), device)

    def reset_parameters(self, generator) -> None:
        for m in (self.ln1, self.ln2, self.attn, self.ssm, self.rwkv,
                  self.moe, self.mlp):
            if m is not None:
                m.reset_parameters(generator)

    def ffn(self, h):
        """The feed-forward half on the normalised stream: (y, aux)."""
        if self.moe is not None:
            return moe_mod.moe_layer(self.moe, h, self.cfg)
        return self.mlp(h), torch.zeros((), dtype=F32, device=h.device)

    def forward(self, x, positions=None, causal: bool = True, latent=None):
        """(B, S, d) -> ((B, S, d), aux) over the full sequence; latent
        attention writes its latents into ``latent`` (see
        :func:`attention.mla_attention`) where given."""
        cfg = self.cfg
        a = layers.apply_norm(cfg.norm, self.ln1, x)
        if self.rwkv is not None:
            x = x + ssm_mod.rwkv6_time_mix(self.rwkv, a, cfg)
            b = layers.apply_norm(cfg.norm, self.ln2, x)
            b_prev = ssm_mod.token_shift(b)
            x = x + ssm_mod.rwkv6_channel_mix(self.rwkv, b, b_prev)
            return x, torch.zeros((), dtype=F32, device=x.device)
        if cfg.mla:
            att = attn_mod.mla_attention(self.attn, a, cfg, latent)
        else:
            att = attn_mod.attention(self.attn, a, cfg, positions=positions,
                                     causal=causal)
        if self.ssm is not None:
            x = x + 0.5 * (att + ssm_mod.mamba_forward(self.ssm, a, cfg))
        else:
            x = x + att
        y, aux = self.ffn(layers.apply_norm(cfg.norm, self.ln2, x))
        return shard(x + y, "batch", None, "embed"), aux


class CrossBlock(nn.Module):
    """Gated cross-attention to ``kv_src``, then an MLP, both pre-norm."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = layers.Norm(cfg.d_model, device)
        self.ln2 = layers.Norm(cfg.d_model, device)
        self.attn = attn_mod.Attention(cfg, device=device)
        self.mlp = layers.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_activation,
                              cfg.weight_dtype(), device)
        self.gate = layers.param((), F32, device)

    def reset_parameters(self, generator) -> None:
        for m in (self.ln1, self.ln2, self.attn, self.mlp):
            m.reset_parameters(generator)
        with torch.no_grad():
            self.gate.zero_()

    def forward(self, x, kv_src):
        cfg = self.cfg
        a = layers.apply_norm(cfg.norm, self.ln1, x)
        ca = attn_mod.cross_attention(self.attn, a, kv_src, cfg)
        # The float32 gate's product is cast back: the stream keeps x's type.
        x = x + (torch.tanh(self.gate) * ca.float()).to(x.dtype)
        return x + self.mlp(layers.apply_norm(cfg.norm, self.ln2, x))


def _blocks(cls, n: int, cfg: ModelConfig, device) -> nn.ModuleList:
    if cls is Block:
        return nn.ModuleList([Block(cfg, device, i) for i in range(n)])
    return nn.ModuleList([cls(cfg, device) for _ in range(n)])


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"model family {cfg.family!r} not in {FAMILIES}")
        self.cfg = cfg
        wdt = cfg.weight_dtype()
        self.embed = layers.Embedding(cfg.vocab_size, cfg.d_model, wdt, device)
        self.final_norm = layers.Norm(cfg.d_model, device)
        n_self = cfg.n_layers
        if cfg.family == "vlm":
            n_cross = cfg.n_layers // cfg.cross_attn_every
            n_self = cfg.n_layers - n_cross
            if n_self != n_cross * (cfg.cross_attn_every - 1):
                raise ValueError(f"vlm: {cfg.n_layers} layers do not make "
                                 f"whole groups of {cfg.cross_attn_every}")
        self.blocks = _blocks(Block, n_self, cfg, device)
        if cfg.family == "vlm":
            self.cross_blocks = _blocks(CrossBlock, n_cross, cfg, device)
        if cfg.family == "audio":
            self.dec_cross = _blocks(CrossBlock, cfg.n_layers, cfg, device)
            self.encoder = _blocks(Block, cfg.encoder_layers, cfg, device)
            self.enc_norm = layers.Norm(cfg.d_model, device)
        self.unembed = (None if cfg.tie_embeddings else
                        layers.Unembed(cfg.d_model, cfg.vocab_size, wdt, device))

    def init_weights(self, generator: torch.Generator) -> "Model":
        """Draw every parameter from ``generator`` (on the model's device):
        truncated normals at +-2 sigma, norms at 1, biases and gates at 0."""
        for m in self.children():
            if isinstance(m, nn.ModuleList):
                for blk in m:
                    blk.reset_parameters(generator)
            else:
                m.reset_parameters(generator)
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    # ------------------------------------------------------------ helpers
    def _logits(self, x):
        cfg = self.cfg
        x = layers.apply_norm(cfg.norm, self.final_norm, x)
        if cfg.tie_embeddings:
            logits = layers.tied_unembed(x, self.embed.table,
                                         cfg.logit_softcap)
        else:
            logits = layers.unembed(x, self.unembed.kernel, cfg.logit_softcap)
        return shard(logits, "batch", None, "vocab")

    def _embed(self, tokens):
        """Token ids (B, S): a host array, a tensor, or a DTensor whose
        rows lie over the mesh."""
        tokens = torch.as_tensor(tokens, device=self.device)
        x = layers.embed(self.embed.table, tokens, scale=self.cfg.embed_scale)
        return shard(x.to(self.cfg.activation_dtype()), "batch", None, "embed")

    def _extra(self, arr):
        """A batch's embeddings in the activation dtype, on the device."""
        return torch.as_tensor(arr, device=self.device).to(
            self.cfg.activation_dtype())

    def _encoder(self, frames):
        """The whisper encoder over frame embeddings (B, T, d): non-causal
        self-attention, with RoPE at positions 0..T-1 as the reference's,
        then ``enc_norm``."""
        x = self._extra(frames)
        for blk in self.encoder:
            x, _ = _remat(functools.partial(blk, causal=False), self.cfg.remat,
                          x)
        return layers.apply_norm(self.cfg.norm, self.enc_norm, x)

    # ------------------------------------------------------------ forward
    def forward(self, batch: Dict, cache: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward.  batch: tokens (B, S), and for vlm
        ``image_embeds`` (B, n_image_tokens, d), for audio ``audio_frames``
        (B, encoder_seq, d).  With latent attention a decode ``cache``
        (:meth:`init_cache`, B rows) may be given: the prompt's latents are
        written into it and its positions set to S, in place, so that
        :meth:`decode_step` goes on from there.

        Returns (logits (B, S, V) f32, aux_loss scalar)."""
        cfg = self.cfg
        x = self._embed(batch["tokens"])
        aux = torch.zeros((), dtype=F32, device=x.device)
        if cache is not None:
            if not cfg.mla:
                raise ValueError("forward fills a decode cache only with "
                                 "latent attention")
            for i, blk in enumerate(self.blocks):
                x, a = blk(x, latent=(cache["c_kv"][i], cache["k_pe"][i]))
                aux = aux + a
            cache["pos"].fill_(x.shape[1])
            return self._logits(x), aux
        if cfg.family == "vlm":
            kv_src = self._extra(batch["image_embeds"])
            for g in range(len(self.cross_blocks)):
                x, a = _remat(self._vlm_group, cfg.remat, x, kv_src, g)
                aux = aux + a
        elif cfg.family == "audio":
            enc = self._encoder(batch["audio_frames"])
            for blk, cross in zip(self.blocks, self.dec_cross):
                x, a = _remat(self._decoder_block, cfg.remat, x, enc, blk,
                              cross)
                aux = aux + a
        else:
            for blk in self.blocks:
                x, a = _remat(blk, cfg.remat, x)
                aux = aux + a
        return self._logits(x), aux

    def _vlm_group(self, x, kv_src, g: int):
        """Group ``g``: self blocks ``g * per_group ...`` (the reference
        reshapes its stacked blocks row-major), then cross block ``g``."""
        per_group = self.cfg.cross_attn_every - 1
        aux = torch.zeros((), dtype=F32, device=x.device)
        for blk in self.blocks[g * per_group:(g + 1) * per_group]:
            x, a = blk(x)
            aux = aux + a
        return self.cross_blocks[g](x, kv_src), aux

    @staticmethod
    def _decoder_block(x, enc, blk, cross):
        x, aux = blk(x)
        return cross(x, enc), aux

    # -------------------------------------------------------------- cache
    def cache_len(self, max_len: int) -> int:
        if self.cfg.sliding_window > 0:
            return min(self.cfg.sliding_window, max_len)
        return max_len

    def init_cache(self, batch: int, max_len: int,
                   extras: Optional[Dict] = None) -> Dict:
        """Decode cache: per-slot positions and the KV caches of every self
        block, (L, B, cache_len, Hkv, hd) in the activation dtype (a ring
        of ``cache_len`` slots when the window fits); for hybrid the Mamba
        states ``ssm`` (L, B, d_inner, N); for ssm no KV cache but the
        RWKV states ``rwkv`` = {``wkv`` (L, B, H, hd, hd), ``x_tm``,
        ``x_cm`` (L, B, d)}, all float32 zeros; for latent attention the
        normalised latents ``c_kv`` (L, B, max_len, Rkv) and rotated key
        parts ``k_pe`` (L, B, max_len, Dr) in place of K and V; for vlm
        ``image_embeds`` (B, n_image_tokens, d), for audio the encoder's
        output ``enc`` (B, encoder_seq, d), zeros unless ``extras`` gives
        them (``extras`` replaces any entry).  Under an installed mesh
        (``sharding.current_mesh``) the cache is laid out over it by
        ``sharding.cache_sharding``, each rank keeping its own part of the
        whole tensors (``extras`` the same on every rank)."""
        cfg = self.cfg
        dev = self.device
        dt = cfg.activation_dtype()
        n = len(self.blocks)
        cache = {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
        if cfg.family == "ssm":
            cache["rwkv"] = {
                k: torch.zeros((n,) + s, dtype=F32, device=dev)
                for k, s in ssm_mod.rwkv6_state_shapes(cfg, batch).items()}
        elif cfg.mla:
            cache["c_kv"] = torch.zeros((n, batch, max_len, cfg.kv_lora_rank),
                                        dtype=dt, device=dev)
            cache["k_pe"] = torch.zeros(
                (n, batch, max_len, cfg.qk_rope_head_dim), dtype=dt,
                device=dev)
        else:
            shape = (n, batch, self.cache_len(max_len), cfg.n_kv_heads,
                     cfg.resolved_head_dim)
            cache["k"] = torch.zeros(shape, dtype=dt, device=dev)
            cache["v"] = torch.zeros(shape, dtype=dt, device=dev)
        if cfg.family == "hybrid":
            cache["ssm"] = torch.zeros(
                (n,) + ssm_mod.mamba_state_shape(cfg, batch), dtype=F32,
                device=dev)
        if cfg.family == "vlm":
            cache["image_embeds"] = torch.zeros(
                (batch, cfg.n_image_tokens, cfg.d_model), dtype=dt, device=dev)
        if cfg.family == "audio":
            cache["enc"] = torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                                       dtype=dt, device=dev)
        if extras:
            cache.update(extras)
        mesh = current_mesh()
        return cache if mesh is None else distribute_cache(cache, mesh)

    # --------------------------------------------------------- decode step
    def decode_step(self, cache: Dict, tokens) -> Tuple:
        """tokens: (B, 1) -> (logits (B, 1, V), cache).

        The returned cache holds the same K/V and state tensors, written in
        place (K/V at each slot's position, or its ring slot), and the
        positions advanced by one.  Cross blocks attend
        ``cache["image_embeds"]`` (vlm) or ``cache["enc"]`` (audio)."""
        cfg = self.cfg
        x = self._embed(tokens)
        pos = cache["pos"]
        if cfg.family == "ssm":
            x = self._decode_rwkv(cache["rwkv"], x)
            return self._logits(x), dict(cache, pos=pos + 1)
        if cfg.mla:
            for i, blk in enumerate(self.blocks):
                a = layers.apply_norm(cfg.norm, blk.ln1, x)
                x = x + attn_mod.mla_decode(blk.attn, a, cache["c_kv"][i],
                                            cache["k_pe"][i], pos, cfg)
                y, _aux = blk.ffn(layers.apply_norm(cfg.norm, blk.ln2, x))
                x = x + y
            return self._logits(x), dict(cache, pos=pos + 1)
        k, v = cache["k"], cache["v"]
        if cfg.family == "vlm":
            per_group = cfg.cross_attn_every - 1
            for g, cross in enumerate(self.cross_blocks):
                for i in range(g * per_group, (g + 1) * per_group):
                    x = self._decode_block(self.blocks[i], x, k[i], v[i], pos)
                x = cross(x, cache["image_embeds"])
        elif cfg.family == "audio":
            for i, (blk, cross) in enumerate(zip(self.blocks, self.dec_cross)):
                x = self._decode_block(blk, x, k[i], v[i], pos)
                x = cross(x, cache["enc"])
        else:
            ssm = cache.get("ssm")
            for i, blk in enumerate(self.blocks):
                x = self._decode_block(blk, x, k[i], v[i], pos,
                                       None if ssm is None else ssm[i])
        cache = dict(cache, pos=pos + 1)
        return self._logits(x), cache

    def _decode_block(self, blk, x, k_c, v_c, pos, ssm_state=None):
        """One self block on one token; a hybrid block's Mamba state
        ``ssm_state`` (B, d_inner, N) is written in place."""
        cfg = self.cfg
        a = layers.apply_norm(cfg.norm, blk.ln1, x)
        att = self._decode_attn(blk.attn, a, k_c, v_c, pos)
        if blk.ssm is not None:
            ssm_out, new_state = ssm_mod.mamba_decode(blk.ssm, a, ssm_state,
                                                      cfg)
            assign(ssm_state, new_state)
            x = x + 0.5 * (att + ssm_out)
        else:
            x = x + att
        y, _aux = blk.ffn(layers.apply_norm(cfg.norm, blk.ln2, x))
        return x + y

    def _decode_attn(self, p_attn, a, k_c, v_c, pos):
        """Single-token attention against the KV cache.  A window that
        fits the cache makes it a ring buffer, except in the vlm and audio
        decoders, which attend through ``decode_attention`` whatever the
        window, as the reference's."""
        cfg = self.cfg
        if (cfg.family not in ("vlm", "audio") and cfg.sliding_window > 0
                and cfg.sliding_window <= k_c.shape[1]):
            return _ring_decode_attention(p_attn, a, k_c, v_c, pos, cfg)
        att, _, _ = attn_mod.decode_attention(p_attn, a, k_c, v_c, pos, cfg)
        return att

    def _decode_rwkv(self, states: Dict, x):
        """The ssm family's blocks on one token, x (B, 1, d); each layer's
        ``wkv``, ``x_tm`` and ``x_cm`` are written in place."""
        cfg = self.cfg
        for i, blk in enumerate(self.blocks):
            a = layers.apply_norm(cfg.norm, blk.ln1, x[:, 0])
            y, new_t = ssm_mod.rwkv6_time_decode(
                blk.rwkv, a, {"wkv": states["wkv"][i],
                              "x_tm": states["x_tm"][i]}, cfg)
            x = x + y[:, None, :]
            b = layers.apply_norm(cfg.norm, blk.ln2, x[:, 0])
            y2, new_cm = ssm_mod.rwkv6_channel_decode(blk.rwkv, b,
                                                      states["x_cm"][i])
            x = x + y2[:, None, :]
            assign(states["wkv"][i], new_t["wkv"])
            assign(states["x_tm"][i], new_t["x_tm"])
            assign(states["x_cm"][i], new_cm)
        return x


def _ring_decode_attention(p_attn, a, k_c, v_c, pos, cfg: ModelConfig):
    """Sliding-window decode against a ring-buffer KV cache.

    k_c/v_c: (B, cache_len, Hkv, hd), each slot's last ``cache_len``
    tokens at buffer index ``position % cache_len``.  RoPE is applied at
    absolute positions before the write, so the ring's rotation does not
    disturb relative phases.  A buffer index counts once written: all of
    them once ``pos + 1 >= cache_len``, else those ``<= pos %
    cache_len``.  The new key and value are written in place; returns y
    (B, 1, d)."""
    b = a.shape[0]
    hd = cfg.resolved_head_dim
    cl = k_c.shape[1]
    pos = torch.as_tensor(pos, device=a.device).reshape(b).long()
    write_idx = pos % max(cl, 1)
    q, k, v = attn_mod._project_qkv(p_attn, a, cfg)
    cos, sin = layers.rope_angles(pos[:, None], hd, cfg.rope_theta)
    q = layers.apply_rope(q, cos, sin)
    k = layers.apply_rope(k, cos, sin)
    put_rows(k_c, write_idx, k[:, 0].to(k_c.dtype))
    put_rows(v_c, write_idx, v[:, 0].to(v_c.dtype))
    slot = torch.arange(cl, device=a.device)[None, :]
    written = (pos + 1 >= cl)[:, None] | (slot <= write_idx[:, None])
    out = local_heads(attn_mod.decode_core, (q, k_c, v_c), rows=(written,))
    return attn_mod._out_proj(p_attn, out, a.dtype)

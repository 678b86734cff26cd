"""Model assembly: the dense and moe families.

One :class:`Model` (an ``nn.Module``) per architecture, built from a
:class:`ModelConfig`:

* ``Model(cfg, device)`` then ``init_weights(generator)`` -> parameters in
  the module (blocks in a ``ModuleList``, one per layer);
* ``forward(batch)``               -> (logits, aux), full sequence
                                      (training / prefill);
* ``init_cache(batch, max_len)``   -> decode cache;
* ``decode_step(cache, tokens)``   -> (logits, cache), one new token.

Blocks are pre-norm: ``x += attn(n(x)); x += ffn(n(x))``, the feed-forward
an MLP (dense) or routed experts plus shared ones (moe, whose blocks also
return the load-balance loss).  ``cfg.remat`` recomputes each block in
the backward pass: ``"full"`` keeps nothing, ``"dots"`` keeps the
products' outputs, ``"none"`` keeps everything; all three give the same
numbers.  The reference's other families (vlm, audio, hybrid, ssm) and
decoding with a sliding window through a ring-buffer cache are not
ported yet (ROADMAP.md, section 1, queue (c)); they raise
``NotImplementedError``.
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
from repro_torch.models.config import ModelConfig

F32 = torch.float32
_NOT_PORTED = "is not ported yet (ROADMAP.md, section 1, queue (c))"
FAMILIES = ("dense", "moe")

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
    block parameter is stacked on a leading layer axis."""
    return p.dim() + int(name.startswith("blocks."))


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = layers.Norm(cfg.d_model, device)
        self.ln2 = layers.Norm(cfg.d_model, device)
        self.attn = attn_mod.Attention(cfg, device=device)
        if cfg.family == "moe":
            self.moe = moe_mod.MoE(cfg, device)
            self.mlp = None
        else:
            self.mlp = layers.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_activation,
                                  cfg.weight_dtype(), device)
            self.moe = None

    def reset_parameters(self, generator) -> None:
        for m in (self.ln1, self.ln2, self.attn, self.moe or self.mlp):
            m.reset_parameters(generator)

    def ffn(self, h):
        """The feed-forward half on the normalised stream: (y, aux)."""
        if self.moe is not None:
            return moe_mod.moe_layer(self.moe, h, self.cfg)
        return self.mlp(h), torch.zeros((), dtype=F32, device=h.device)

    def forward(self, x, positions=None):
        """(B, S, d) -> ((B, S, d), aux) over the full sequence."""
        cfg = self.cfg
        a = layers.apply_norm(cfg.norm, self.ln1, x)
        x = x + attn_mod.attention(self.attn, a, cfg, positions=positions)
        y, aux = self.ffn(layers.apply_norm(cfg.norm, self.ln2, x))
        return x + y, aux


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(f"model family {cfg.family!r} {_NOT_PORTED}")
        self.cfg = cfg
        wdt = cfg.weight_dtype()
        self.embed = layers.Embedding(cfg.vocab_size, cfg.d_model, wdt, device)
        self.final_norm = layers.Norm(cfg.d_model, device)
        self.blocks = nn.ModuleList(
            [Block(cfg, device) for _ in range(cfg.n_layers)])
        self.unembed = (None if cfg.tie_embeddings else
                        layers.Unembed(cfg.d_model, cfg.vocab_size, wdt, device))

    def init_weights(self, generator: torch.Generator) -> "Model":
        """Draw every parameter from ``generator`` (on the model's device):
        truncated normals at +-2 sigma, norms at 1, biases at 0."""
        self.embed.reset_parameters(generator)
        self.final_norm.reset_parameters(generator)
        for blk in self.blocks:
            blk.reset_parameters(generator)
        if self.unembed is not None:
            self.unembed.reset_parameters(generator)
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    # ------------------------------------------------------------ helpers
    def _logits(self, x):
        cfg = self.cfg
        x = layers.apply_norm(cfg.norm, self.final_norm, x)
        if cfg.tie_embeddings:
            return layers.tied_unembed(x, self.embed.table, cfg.logit_softcap)
        return layers.unembed(x, self.unembed.kernel, cfg.logit_softcap)

    def _embed(self, tokens):
        tokens = torch.as_tensor(tokens, device=self.device)
        x = layers.embed(self.embed.table, tokens, scale=self.cfg.embed_scale)
        return x.to(self.cfg.activation_dtype())

    # ------------------------------------------------------------ forward
    def forward(self, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward.  batch: tokens (B, S).

        Returns (logits (B, S, V) f32, aux_loss scalar)."""
        x = self._embed(batch["tokens"])
        aux = torch.zeros((), dtype=F32, device=x.device)
        for blk in self.blocks:
            x, a = _remat(blk, self.cfg.remat, x)
            aux = aux + a
        return self._logits(x), aux

    # -------------------------------------------------------------- cache
    def cache_len(self, max_len: int) -> int:
        if self.cfg.sliding_window > 0:
            return min(self.cfg.sliding_window, max_len)
        return max_len

    def init_cache(self, batch: int, max_len: int,
                   extras: Optional[Dict] = None) -> Dict:
        """Decode cache: per-slot positions and the KV caches of every
        layer, (L, B, cache_len, Hkv, hd) in the activation dtype."""
        cfg = self.cfg
        dev = self.device
        cl = self.cache_len(max_len)
        shape = (cfg.n_layers, batch, cl, cfg.n_kv_heads, cfg.resolved_head_dim)
        cache = {
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "k": torch.zeros(shape, dtype=cfg.activation_dtype(), device=dev),
            "v": torch.zeros(shape, dtype=cfg.activation_dtype(), device=dev),
        }
        if extras:
            cache.update(extras)
        return cache

    # --------------------------------------------------------- decode step
    def decode_step(self, cache: Dict, tokens) -> Tuple:
        """tokens: (B, 1) -> (logits (B, 1, V), cache).

        The returned cache holds the same K/V tensors, written in place at
        each slot's position, and the positions advanced by one."""
        cfg = self.cfg
        x = self._embed(tokens)
        pos = cache["pos"]
        for i, blk in enumerate(self.blocks):
            a = layers.apply_norm(cfg.norm, blk.ln1, x)
            att = self._decode_attn(blk.attn, a, cache["k"][i], cache["v"][i],
                                    pos)
            x = x + att
            y, _aux = blk.ffn(layers.apply_norm(cfg.norm, blk.ln2, x))
            x = x + y
        cache = dict(cache, pos=pos + 1)
        return self._logits(x), cache

    def _decode_attn(self, p_attn, a, k_c, v_c, pos):
        """Single-token attention against the KV cache."""
        cfg = self.cfg
        if cfg.sliding_window > 0 and cfg.sliding_window <= k_c.shape[1]:
            raise NotImplementedError(
                f"sliding-window decoding through a ring buffer {_NOT_PORTED}")
        att, _, _ = attn_mod.decode_attention(p_attn, a, k_c, v_c, pos, cfg)
        return att

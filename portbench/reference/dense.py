"""Plain float32 reference of the dense family (starcoder2-3b).

Written from ``repro``'s equations (``src/repro/models/transformer.py``,
``attention.py``, ``layers.py``), not from the port:

    x = table[tokens]
    per layer:  a = norm(x; ln1)
                q, k, v = a Wq + bq, a Wk + bk, a Wv + bv   (H, Hkv heads of D)
                q, k rotated at their positions (RoPE, halves of the head)
                o = softmax(q k^T / sqrt(D) + mask) v, each query head on
                    its group's key head; the mask keeps keys j with
                    i - window < j <= i
                x = x + o Wo
                x = x + act(norm(x; ln2) Wi) Wo_mlp    (gelu, tanh form)
    logits = norm(x; final_norm) U

Everything in float32; the port keeps its activations in bfloat16 between
products.  Queries are taken in blocks so that the scores fit.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.common import embed, norm, product

F32 = torch.float32
#: Query rows a block of attention scores holds.
Q_BLOCK = 1024


def head_dim(cfg) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def param_specs(cfg):
    d, v, dff = cfg["d_model"], cfg["vocab_size"], cfg["d_ff"]
    h, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    scale = ("normal", 1.0, 0.1)
    specs = {"embed.table": ((v, d), "bfloat16", ("normal", 0.0, 1.0)),
             "final_norm.scale": ((d,), "float32", scale)}
    if not cfg.get("tie_embeddings"):
        specs["unembed.kernel"] = ((d, v), "bfloat16",
                                   ("normal", 0.0, d ** -0.5))
    for i in range(cfg["n_layers"]):
        p = f"blocks.{i}."
        specs[p + "ln1.scale"] = ((d,), "float32", scale)
        specs[p + "ln2.scale"] = ((d,), "float32", scale)
        specs[p + "attn.wq"] = ((d, h, hd), "bfloat16",
                                ("normal", 0.0, d ** -0.5))
        specs[p + "attn.wk"] = ((d, hkv, hd), "bfloat16",
                                ("normal", 0.0, d ** -0.5))
        specs[p + "attn.wv"] = ((d, hkv, hd), "bfloat16",
                                ("normal", 0.0, d ** -0.5))
        specs[p + "attn.wo"] = ((h, hd, d), "bfloat16",
                                ("normal", 0.0, (h * hd) ** -0.5))
        if cfg.get("qkv_bias"):
            for name, heads in (("bq", h), ("bk", hkv), ("bv", hkv)):
                specs[p + "attn." + name] = ((heads, hd), "bfloat16",
                                             ("normal", 0.0, 0.1))
        specs[p + "mlp.wi"] = ((d, dff), "bfloat16",
                               ("normal", 0.0, d ** -0.5))
        if cfg.get("mlp_activation", "swiglu") in ("swiglu", "geglu"):
            specs[p + "mlp.wi_gate"] = ((d, dff), "bfloat16",
                                        ("normal", 0.0, d ** -0.5))
        specs[p + "mlp.wo"] = ((dff, d), "bfloat16",
                               ("normal", 0.0, dff ** -0.5))
    return specs


def rope(x, theta: float):
    """x (B, S, H, D) rotated at positions 0..S-1: the first half of
    each head against the second, frequencies theta^(-i / (D/2))."""
    s, dh = x.shape[1], x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(half, dtype=F32, device=x.device) / half)
    ang = torch.arange(s, dtype=F32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attend(q, k, v, window: int):
    """Causal attention with a window: q (B, S, H, D), k/v (B, S, Hkv,
    D) -> (B, S, H, D)."""
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, s, hkv, g, dh)
    out = torch.empty_like(q)
    for i0 in range(0, s, Q_BLOCK):
        i1 = min(i0 + Q_BLOCK, s)
        j0 = max(0, i0 - window + 1) if window > 0 else 0
        sc = torch.einsum("bqkgd,bskd->bkgqs", qg[:, i0:i1],
                          k[:, j0:i1]) / math.sqrt(dh)
        qi = torch.arange(i0, i1, device=q.device)[:, None]
        kj = torch.arange(j0, i1, device=q.device)[None, :]
        keep = kj <= qi
        if window > 0:
            keep &= kj > qi - window
        sc = sc.masked_fill(~keep, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", p, v[:, j0:i1])
        out[:, i0:i1] = o.reshape(b, i1 - i0, h, dh)
    return out


def _act(kind: str, h, gate=None):
    if kind == "swiglu":
        return F.silu(gate) * h
    if kind == "geglu":
        return F.gelu(gate, approximate="tanh") * h
    return F.gelu(h, approximate="tanh")


def hidden(weights, cfg, tokens: torch.Tensor, fp8: bool = False):
    """Final-normed hidden states (B, S, d) float32 of ``tokens`` (B, S)."""
    b, s = tokens.shape
    d, h, hkv, hd = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                     head_dim(cfg))
    kind = cfg.get("norm", "rmsnorm")
    act = cfg.get("mlp_activation", "swiglu")
    x = embed(weights["embed.table"], tokens)
    for i in range(cfg["n_layers"]):
        p = f"blocks.{i}."

        def proj(name, heads):
            y = product(a, weights[p + "attn." + name].reshape(d, -1), fp8)
            bias = weights.get(p + "attn.b" + name[1])
            if bias is not None:
                y = y + bias.to(F32).reshape(-1)
            return y.reshape(b, s, heads, hd)

        a = norm(kind, x, weights[p + "ln1.scale"])
        q = rope(proj("wq", h), cfg["rope_theta"])
        k = rope(proj("wk", hkv), cfg["rope_theta"])
        v = proj("wv", hkv)
        o = attend(q, k, v, cfg.get("sliding_window", 0))
        x = x + product(o.reshape(b, s, h * hd),
                        weights[p + "attn.wo"].reshape(h * hd, d), fp8)
        a = norm(kind, x, weights[p + "ln2.scale"])
        gate = (product(a, weights[p + "mlp.wi_gate"], fp8)
                if act in ("swiglu", "geglu") else None)
        m = _act(act, product(a, weights[p + "mlp.wi"], fp8), gate)
        x = x + product(m, weights[p + "mlp.wo"], fp8)
    return norm(kind, x, weights["final_norm.scale"])

"""Model FLOPs of a forward pass, counted from a configuration's shapes.

The count is of the model, the same whatever implements it: each product
of an ``m x k`` input with a ``k x n`` weight is ``2 m k n``; attention is
:mod:`counts.attention`'s; the RWKV6 recurrence is its elementwise
operations on the (head dim x head dim) state of each head.  Norms,
activations, the embedding lookup and other elementwise work are left
out (under 1% of either model here).  ``cfg`` is the ``model`` object of a
configuration file.
"""

from __future__ import annotations

from portbench.counts import attention

#: Elementwise operations of one RWKV6 recurrence step per state entry:
#: k v^T (1), u * kv (1), S + u kv (1), r . (...) (2), w * S (1), + kv (1).
RWKV_STATE_OPS = 7


def _head_dim(cfg) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def dense_products_per_token(cfg) -> float:
    """Weights a token multiplies through once per forward, in the dense
    family: Q, K, V and the output projection, the MLP, and the logits."""
    d, hd = cfg["d_model"], _head_dim(cfg)
    h, hkv = cfg["n_heads"], cfg["n_kv_heads"]
    n_in = 2 if cfg.get("mlp_activation", "swiglu") in ("swiglu",
                                                        "geglu") else 1
    attn = d * h * hd + 2 * d * hkv * hd + h * hd * d
    mlp = (n_in + 1) * d * cfg["d_ff"]
    return cfg["n_layers"] * (attn + mlp) + d * cfg["vocab_size"]


def ssm_products_per_token(cfg) -> float:
    """The ssm (RWKV6) family: r, k, v, g, the decay and the output
    (six d x d), the channel mix (d x 3.5 d twice, d x d), the logits."""
    d = cfg["d_model"]
    dff = int(3.5 * d)
    return cfg["n_layers"] * (7 * d * d + 2 * d * dff) + d * cfg["vocab_size"]


def _rwkv_state_flops_per_token(cfg) -> float:
    h = cfg.get("ssm_heads") or max(cfg["d_model"] // 64, 1)
    hd = cfg["d_model"] // h
    return cfg["n_layers"] * RWKV_STATE_OPS * h * hd * hd


def prefill_flops(cfg, batch: int, seq: int) -> float:
    """FLOPs of a forward over ``batch`` sequences of ``seq`` tokens."""
    tokens = batch * seq
    if cfg["family"] == "ssm":
        return tokens * (2.0 * ssm_products_per_token(cfg)
                         + _rwkv_state_flops_per_token(cfg))
    if cfg["family"] != "dense":
        raise ValueError(f"no count for family {cfg['family']!r}")
    att = cfg["n_layers"] * attention.flops(
        batch, seq, cfg["n_heads"], _head_dim(cfg),
        cfg.get("sliding_window", 0))
    return tokens * 2.0 * dense_products_per_token(cfg) + att


def decode_flops(cfg, positions) -> float:
    """FLOPs of decode steps that process one token each at the given
    positions (0-based; the token at position ``p`` attends ``p + 1``
    keys, or the window's)."""
    n = len(positions)
    if cfg["family"] == "ssm":
        return n * (2.0 * ssm_products_per_token(cfg)
                    + _rwkv_state_flops_per_token(cfg))
    if cfg["family"] != "dense":
        raise ValueError(f"no count for family {cfg['family']!r}")
    window = cfg.get("sliding_window", 0)
    keys = sum(min(p + 1, window) if window > 0 else p + 1
               for p in positions)
    per_key = 4.0 * cfg["n_heads"] * _head_dim(cfg) * cfg["n_layers"]
    return n * 2.0 * dense_products_per_token(cfg) + per_key * keys

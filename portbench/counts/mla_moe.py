"""Model FLOPs and the roofline's least times of latent attention (MLA)
and sigmoid-routed experts held in part (Kimi-K2's layer), counted from a
configuration's shapes.

The count is of the model, whatever implements it: each product of an
``m x k`` input with a ``k x n`` weight is ``2 m k n``.  Per token:

    MLA        d Rq + Rq H (Dn + Dr) + d (Rkv + Dr) + Rkv H (Dn + Dv)
               + H Dv d
    dense MLP  3 d dff, in the first ``first_k_dense`` layers
    MoE        the router d R, the shared experts 3 d f S, and the routed
               experts held here at their expected share: k E / R of a
               token's k pairs land on them, 3 d f each
    logits     d V

Attention: every causal (query, key) pair of a head costs ``2 (Dn + Dr)``
for the scores and ``2 Dv`` for the values.  Norms, activations, rotation,
the routing's sort and the embedding lookup are left out.  ``cfg`` is the
``model`` object of a configuration file.
"""

from __future__ import annotations

from portbench.counts import h100


def _dims(cfg):
    return (cfg["d_model"], cfg["n_heads"], cfg["q_lora_rank"],
            cfg["kv_lora_rank"], cfg["qk_nope_head_dim"],
            cfg["qk_rope_head_dim"], cfg["v_head_dim"])


def mla_weights(cfg) -> int:
    d, h, rq, rkv, dn, dr, dv = _dims(cfg)
    return (d * rq + rq * h * (dn + dr) + d * (rkv + dr) + rkv * h * (dn + dv)
            + h * dv * d)


def expert_weights(cfg) -> int:
    """One routed expert's three products."""
    return 3 * cfg["d_model"] * cfg["moe_d_ff"]


def moe_weights_per_token(cfg) -> float:
    """Weights a token multiplies through in one MoE layer: the router,
    the shared experts and the held experts' expected share."""
    routed = cfg.get("router_experts") or cfg["n_experts"]
    k = cfg["n_experts_per_token"]
    return (cfg["d_model"] * routed
            + cfg.get("n_shared_experts", 0) * expert_weights(cfg)
            + k * cfg["n_experts"] / routed * expert_weights(cfg))


def products_per_token(cfg) -> float:
    dense = cfg.get("first_k_dense", 0)
    return (cfg["n_layers"] * mla_weights(cfg)
            + dense * 3 * cfg["d_model"] * cfg["d_ff"]
            + (cfg["n_layers"] - dense) * moe_weights_per_token(cfg)
            + cfg["d_model"] * cfg["vocab_size"])


def causal_pairs(seq: int) -> int:
    return seq * (seq + 1) // 2


def attention_flops(cfg, batch: int, seq: int) -> float:
    """One layer's MLA attention over ``batch`` sequences of ``seq``."""
    _, h, _, _, dn, dr, dv = _dims(cfg)
    return 2.0 * (dn + dr + dv) * h * batch * causal_pairs(seq)


def attention_bytes(cfg, batch: int, seq: int, elem_bytes: int) -> float:
    """Q and K (Dn + Dr), V and the output (Dv) of every head, each read
    or written once."""
    _, h, _, _, dn, dr, dv = _dims(cfg)
    return float(batch * seq * h * (2 * (dn + dr) + 2 * dv) * elem_bytes)


def attention_least_seconds(cfg, batch: int, seq: int,
                            elem_bytes: int) -> float:
    """The roofline's least time of one layer's attention call: the larger
    of its FLOPs over the bfloat16 peak and its bytes over HBM's rate."""
    return max(attention_flops(cfg, batch, seq) / h100.PEAK_BF16_FLOPS,
               attention_bytes(cfg, batch, seq, elem_bytes) / h100.HBM_BW)


def experts_least_seconds(cfg, pairs: int, elem_bytes: int) -> float:
    """The least time of one layer's held experts for ``pairs`` (token,
    slot) pairs that landed on them: their three products' FLOPs over the
    peak, or the held experts' weights read once and each pair's input
    row read and output row written once, over HBM's rate."""
    flops = 2.0 * pairs * expert_weights(cfg)
    moved = (cfg["n_experts"] * expert_weights(cfg)
             + 2 * pairs * cfg["d_model"]) * elem_bytes
    return max(flops / h100.PEAK_BF16_FLOPS, moved / h100.HBM_BW)


def prefill_flops(cfg, batch: int, seq: int) -> float:
    """FLOPs of a forward over ``batch`` sequences of ``seq`` tokens."""
    return (batch * seq * 2.0 * products_per_token(cfg)
            + cfg["n_layers"] * attention_flops(cfg, batch, seq))

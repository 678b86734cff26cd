"""Plain float32 reference of the moe family as Kimi-K2-Instruct states it
(DeepSeek-V3's layout: https://huggingface.co/moonshotai/Kimi-K2-Instruct).

Written from the published equations, not from the port:

    x = table[tokens]
    per layer:  a = rms(x; ln1)
                c_q = rms(a Wq_a; q_norm);  q = c_q Wq_b   (H heads of
                                              Dn | Dr)
                [c | k_r] = a Wkv_a;  c = rms(c; kv_norm)
                [k_n | v] = c Wkv_b                 (H heads of Dn | Dv)
                q_r, k_r rotated at their positions (YaRN, halves of the
                    Dr dims; k_r one for every head)
                o = softmax((q_n k_n + q_r k_r) * scale + causal) v,
                    scale = (Dn + Dr)^-1/2 * mscale(factor, mscale_all)^2
                x = x + o Wo
                h = rms(x; ln2)
                first_k_dense layers:  x = x + SwiGLU_dff(h)
                the others:  s = sigmoid(h Wr) over all R router experts
                             top = the k largest of s + b (b the correction
                                   bias, only for choosing; a stable sort,
                                   the lower id first on ties)
                             w_i = scaling * s_i / sum_top s
                             x = x + sum_{i in top, held} w_i E_i(h) + S(h)
    logits = rms(x; final_norm) U

``held`` is the ``n_experts`` experts numbered from ``expert_offset``
(this chip's share under expert parallelism); E_i and the shared S are
SwiGLU of ``moe_d_ff``.  Everything in float32; queries are taken in
blocks so that the scores fit.

A :class:`Routes` given to :func:`hidden` records each moe layer's
choice, or makes the layers follow the choices of another pass (the
program's, or the control's) and records how far each followed choice
lies from the reference's own: a comparison of a routed model in which
a rounding that swaps the k-th and the (k+1)-th expert is judged by the
scores it swapped, and not by the logits it moved.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.common import embed, product, rms_norm

F32 = torch.float32
#: Query rows a block of attention scores holds.
Q_BLOCK = 512
#: The correction bias's draw (``assumed`` in the configuration).
BIAS_STD = 0.05


def param_specs(cfg):
    d, v, h = cfg["d_model"], cfg["vocab_size"], cfg["n_heads"]
    rq, rkv = cfg["q_lora_rank"], cfg["kv_lora_rank"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    routed = cfg.get("router_experts") or cfg["n_experts"]
    e, f = cfg["n_experts"], cfg["moe_d_ff"]
    shared = f * cfg.get("n_shared_experts", 0)
    scale = ("normal", 1.0, 0.1)

    def normal(*shape, fan_in, dtype="bfloat16", residual=False):
        # The residual branches' output projections at GPT-2's scaled
        # initialisation: 1 / sqrt(2 L) more, L the layers drawn.
        std = fan_in ** -0.5 * (residual_scale if residual else 1.0)
        return (shape, dtype, ("normal", 0.0, std))

    residual_scale = (2 * cfg["n_layers"]) ** -0.5

    specs = {"embed.table": ((v, d), "bfloat16", ("normal", 0.0, 1.0)),
             "final_norm.scale": ((d,), "float32", scale),
             "unembed.kernel": normal(d, v, fan_in=d)}
    for i in range(cfg["n_layers"]):
        p = f"blocks.{i}."
        specs[p + "ln1.scale"] = ((d,), "float32", scale)
        specs[p + "ln2.scale"] = ((d,), "float32", scale)
        specs[p + "attn.wq_a"] = normal(d, rq, fan_in=d)
        specs[p + "attn.q_norm.scale"] = ((rq,), "float32", scale)
        specs[p + "attn.wq_b"] = normal(rq, h, dn + dr, fan_in=rq)
        specs[p + "attn.wkv_a"] = normal(d, rkv + dr, fan_in=d)
        specs[p + "attn.kv_norm.scale"] = ((rkv,), "float32", scale)
        specs[p + "attn.wkv_b"] = normal(rkv, h, dn + dv, fan_in=rkv)
        specs[p + "attn.wo"] = normal(h, dv, d, fan_in=h * dv, residual=True)
        if i < cfg.get("first_k_dense", 0):
            specs[p + "mlp.wi"] = normal(d, cfg["d_ff"], fan_in=d)
            specs[p + "mlp.wi_gate"] = normal(d, cfg["d_ff"], fan_in=d)
            specs[p + "mlp.wo"] = normal(cfg["d_ff"], d, fan_in=cfg["d_ff"],
                                         residual=True)
            continue
        specs[p + "moe.router"] = normal(d, routed, fan_in=d, dtype="float32")
        specs[p + "moe.router_bias"] = ((routed,), "float32",
                                        ("normal", 0.0, BIAS_STD))
        specs[p + "moe.experts_wi"] = normal(e, d, f, fan_in=d)
        specs[p + "moe.experts_wi_gate"] = normal(e, d, f, fan_in=d)
        specs[p + "moe.experts_wo"] = normal(e, f, d, fan_in=f, residual=True)
        if shared:
            specs[p + "moe.shared_wi"] = normal(d, shared, fan_in=d)
            specs[p + "moe.shared_wi_gate"] = normal(d, shared, fan_in=d)
            specs[p + "moe.shared_wo"] = normal(shared, d, fan_in=shared,
                                                residual=True)
    return specs


def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def inv_freq(cfg, device=None):
    """The Dr / 2 rotation frequencies: base^(-2i/Dr), and with YaRN
    (factor > 1) those past the correction range divided by the factor,
    a linear ramp between."""
    dim, base = cfg["qk_rope_head_dim"], cfg["rope_theta"]
    freq = base ** (-torch.arange(0, dim, 2, dtype=F32, device=device) / dim)
    factor = cfg.get("rope_scaling_factor", 0.0)
    if factor <= 1:
        return freq
    orig = cfg["rope_original_max_len"]

    def dim_of(rotations):
        # The dim whose wavelength fits ``rotations`` turns in ``orig``.
        return dim * math.log(orig / (rotations * 2 * math.pi)) / (
            2 * math.log(base))

    lo = max(math.floor(dim_of(cfg["rope_beta_fast"])), 0)
    hi = min(math.ceil(dim_of(cfg["rope_beta_slow"])), dim - 1)
    hi = hi + 0.001 if hi == lo else hi
    ramp = ((torch.arange(dim // 2, dtype=F32, device=device) - lo)
            / (hi - lo)).clamp(0, 1)
    return freq * (1 - ramp) + freq / factor * ramp


def softmax_scale(cfg) -> float:
    s = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    factor = cfg.get("rope_scaling_factor", 0.0)
    if factor > 1 and cfg.get("rope_mscale_all_dim"):
        s *= _mscale(factor, cfg["rope_mscale_all_dim"]) ** 2
    return s


def rope(x, cfg):
    """x (B, S, H, Dr) rotated at positions 0..S-1, halves of the dims."""
    s, half = x.shape[1], x.shape[-1] // 2
    ang = (torch.arange(s, dtype=F32, device=x.device)[:, None]
           * inv_freq(cfg, x.device))
    m = 1.0
    factor = cfg.get("rope_scaling_factor", 0.0)
    if factor > 1:
        m = (_mscale(factor, cfg.get("rope_mscale", 1.0))
             / _mscale(factor, cfg.get("rope_mscale_all_dim", 0.0)))
    cos = (torch.cos(ang) * m)[:, None, :]
    sin = (torch.sin(ang) * m)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(w, p, cfg, a, fp8):
    b, s, d = a.shape
    h = cfg["n_heads"]
    rkv, dn = cfg["kv_lora_rank"], cfg["qk_nope_head_dim"]
    c_q = rms_norm(product(a, w[p + "attn.wq_a"], fp8),
                   w[p + "attn.q_norm.scale"])
    q = product(c_q, w[p + "attn.wq_b"].reshape(c_q.shape[-1], -1),
                fp8).reshape(b, s, h, -1)
    kv_a = product(a, w[p + "attn.wkv_a"], fp8)
    c = rms_norm(kv_a[..., :rkv], w[p + "attn.kv_norm.scale"])
    kv = product(c, w[p + "attn.wkv_b"].reshape(rkv, -1), fp8).reshape(
        b, s, h, -1)
    # Heads first (B, H, S, .), so that each block is a batched product.
    k_n = kv[..., :dn].transpose(1, 2).contiguous()
    v = kv[..., dn:].transpose(1, 2).contiguous()
    q_n = q[..., :dn].transpose(1, 2).contiguous()
    q_r = rope(q[..., dn:], cfg).transpose(1, 2).contiguous()
    k_r = rope(kv_a[..., None, rkv:], cfg)[:, :, 0]           # (B, S, Dr)
    scale = softmax_scale(cfg)
    o = torch.empty((b, h, s, v.shape[-1]), dtype=F32, device=a.device)
    for i0 in range(0, s, Q_BLOCK):
        i1 = min(i0 + Q_BLOCK, s)
        sc = (q_n[:, :, i0:i1] @ k_n[:, :, :i1].transpose(-1, -2)
              + q_r[:, :, i0:i1] @ k_r[:, None, :i1].transpose(-1, -2))
        qi = torch.arange(i0, i1, device=a.device)[:, None]
        kj = torch.arange(i1, device=a.device)[None, :]
        sc = (sc * scale).masked_fill(kj > qi, float("-inf"))
        o[:, :, i0:i1] = torch.softmax(sc, dim=-1) @ v[:, :, :i1]
    o = o.transpose(1, 2)
    return product(o.reshape(b, s, -1),
                   w[p + "attn.wo"].reshape(-1, d), fp8)


def _swiglu(x, wi, wg, wo, fp8):
    return product(F.silu(product(x, wg, fp8)) * product(x, wi, fp8), wo, fp8)


class Routes:
    """The moe layers' choices, in order.  ``follow`` None: each layer
    chooses its own, appended to ``ids`` ((T, k) a layer).  ``follow`` a
    list of such choices: layer j takes ``follow[j]``, and appends to
    ``gaps`` its widest route gap, the largest over tokens of how far the
    choice score s + b of the weakest expert followed lies below the
    reference's own k-th best (0 where the sets agree)."""

    def __init__(self, follow=None):
        self.follow, self.ids, self.gaps = follow, [], []


def _moe(w, p, cfg, hh, fp8, routes=None):
    """The held experts' part plus the shared expert, hh (B, S, d)."""
    shape = hh.shape
    h = hh.reshape(-1, shape[-1])
    k = cfg["n_experts_per_token"]
    s = torch.sigmoid(product(h, w[p + "moe.router"], fp8))
    choice = s + w[p + "moe.router_bias"].to(F32)
    if routes is not None and routes.follow is not None:
        top = routes.follow[len(routes.ids)].to(h.device).long()
        kth = choice.topk(k, dim=-1).values[:, -1]
        routes.gaps.append(float(
            (kth - choice.gather(1, top).min(-1).values).max()))
    else:
        top = torch.sort(choice, dim=-1, descending=True,
                         stable=True).indices[:, :k]
    if routes is not None:
        routes.ids.append(top)
    ws = s.gather(1, top)
    ws = ws / (ws.sum(-1, keepdim=True) + 1e-20) * cfg.get(
        "routed_scaling_factor", 1.0)
    y = torch.zeros_like(h)
    first = cfg.get("expert_offset", 0)
    for j in range(cfg["n_experts"]):
        hit = top == first + j                               # (T, k)
        rows = hit.any(-1).nonzero()[:, 0]
        if len(rows) == 0:
            continue
        weight = (ws * hit).sum(-1)[rows, None]
        y[rows] += weight * _swiglu(
            h[rows], w[p + "moe.experts_wi"][j],
            w[p + "moe.experts_wi_gate"][j], w[p + "moe.experts_wo"][j], fp8)
    if p + "moe.shared_wi" in w:
        y = y + _swiglu(h, w[p + "moe.shared_wi"], w[p + "moe.shared_wi_gate"],
                        w[p + "moe.shared_wo"], fp8)
    return y.reshape(shape)


def hidden(weights, cfg, tokens: torch.Tensor, fp8: bool = False,
           routes: Routes = None):
    """Final-normed hidden states (B, S, d) float32 of ``tokens`` (B, S);
    the moe layers' choices recorded in, or taken from, ``routes`` (a
    :class:`Routes`, choices of B * S rows a layer) where given."""
    w = weights
    x = embed(w["embed.table"], tokens)
    for i in range(cfg["n_layers"]):
        p = f"blocks.{i}."
        x = x + _attention(w, p, cfg, rms_norm(x, w[p + "ln1.scale"]), fp8)
        hh = rms_norm(x, w[p + "ln2.scale"])
        if i < cfg.get("first_k_dense", 0):
            x = x + _swiglu(hh, w[p + "mlp.wi"], w[p + "mlp.wi_gate"],
                            w[p + "mlp.wo"], fp8)
        else:
            x = x + _moe(w, p, cfg, hh, fp8, routes)
    return rms_norm(x, w["final_norm.scale"])

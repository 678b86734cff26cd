"""Plain float32 reference of the ssm family (rwkv6-3b, RWKV6 "Finch").

Written from ``repro``'s equations (``src/repro/models/ssm.py``:
``_rwkv_time_inputs``, ``_rwkv_step``, ``rwkv6_channel_mix``;
``transformer.py``'s ssm block), not from the port:

    x = table[tokens]
    per layer:  a = norm(x; ln1), a' = a one step earlier (0 at step 0)
                mix(mu) = a (1 - mu) + a' mu
                r, k, v, g = mix(mu_r) Wr, mix(mu_k) Wk, mix(mu_v) Wv,
                             mix(mu_g) Wg
                w = exp(-exp(mix(mu_w) Ww + b_w))          (decay in (0, 1))
                per head (H heads of D = d / H), state S (D x D) from 0:
                    o_t = r_t^T (S_t + diag(u) k_t v_t^T)
                    S_{t+1} = diag(w_t) S_t + k_t v_t^T
                x = x + (o * ln_x * silu(g)) Wout
                b = norm(x; ln2), b' = b one step earlier
                x = x + sigmoid((b (1-mu_cr) + b' mu_cr) Wcr)
                        * (relu((b (1-mu_ck) + b' mu_ck) Wck)^2 Wcv)
    logits = norm(x; final_norm) U

The recurrence is taken here in its chunked form, which is exact in exact
arithmetic and is not the port's step loop: within a chunk of ``CHUNK``
steps, with ``C_i`` the running sum of ``log w`` through step ``i`` and
``P_i = C_i - log w_i``,

    o_i = (r_i e^{P_i})^T S_0
          + sum_{j<i} [sum_c r_i[c] k_j[c] e^{P_i[c] - C_j[c]}] v_j
          + (sum_c r_i[c] u[c] k_i[c]) v_i
    S_T = e^{C_{T-1}} S_0 + sum_j (k_j e^{C_{T-1} - C_j}) v_j^T

where every exponent is at most 0.  Everything in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import embed, norm, product

F32 = torch.float32
#: Steps of the recurrence taken together.
CHUNK = 64

#: The scale ``ln_x`` is drawn at.  The published block normalises each
#: head's wkv output with a GroupNorm (its ``ln_x``); ``repro`` keeps only
#: a per-channel scale, so the draw gives that scale the size that brings
#: the output back to about unit scale: an entry of ``r^T S`` sums D = 64
#: products over a state that remembers about 4 steps at the drawn decay
#: (about 0.87), so 1 / sqrt(64 * 4).  At a scale of 1 every layer's
#: output is about 16 times the residual stream's, and 32 such layers
#: amplify any rounding until the float32 reference and the port in
#: bfloat16 disagree by logits of 1.5-1.9.
LN_X = 1.0 / 16.0

_MIXES = ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "mu_ck", "mu_cr")


def heads(cfg) -> int:
    return cfg.get("ssm_heads") or max(cfg["d_model"] // 64, 1)


def param_specs(cfg):
    d, v = cfg["d_model"], cfg["vocab_size"]
    dff = int(3.5 * d)
    h = heads(cfg)
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
        for name in _MIXES:
            specs[p + "rwkv." + name] = ((d,), "float32", ("sigmoid",))
        for name in ("w_r", "w_k", "w_v", "w_g", "w_out", "w_cr"):
            specs[p + "rwkv." + name] = ((d, d), "bfloat16",
                                         ("normal", 0.0, d ** -0.5))
        specs[p + "rwkv.w_w"] = ((d, d), "bfloat16",
                                 ("normal", 0.0, 0.1 * d ** -0.5))
        specs[p + "rwkv.b_w"] = ((d,), "float32", ("normal", -2.0, 0.5))
        specs[p + "rwkv.u_bonus"] = ((h, d // h), "float32",
                                     ("normal", 0.0, 0.5))
        specs[p + "rwkv.ln_x"] = ((d,), "float32",
                                  ("normal", LN_X, 0.1 * LN_X))
        specs[p + "rwkv.w_ck"] = ((d, dff), "bfloat16",
                                  ("normal", 0.0, d ** -0.5))
        specs[p + "rwkv.w_cv"] = ((dff, d), "bfloat16",
                                  ("normal", 0.0, dff ** -0.5))
    return specs


def shift(x):
    """x (B, S, d) one step later in time, zeros at step 0."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def wkv(r, k, v, logw, u):
    """The recurrence over (B, S, H, D) inputs from a zero state -> o (B,
    S, H, D); ``logw`` is log w (at most 0), ``u`` (H, D)."""
    b, s, h, dh = r.shape
    r, k, v, logw = (t.transpose(1, 2) for t in (r, k, v, logw))  # B,H,S,D
    state = r.new_zeros((b, h, dh, dh))
    out = torch.empty_like(r)
    for t0 in range(0, s, CHUNK):
        rc, kc, vc, lw = (t[:, :, t0:t0 + CHUNK] for t in (r, k, v, logw))
        n = rc.shape[2]
        c = torch.cumsum(lw, dim=2)
        pre = c - lw
        o = torch.einsum("bhic,bhcv->bhiv", rc * torch.exp(pre), state)
        expo = pre[:, :, :, None, :] - c[:, :, None, :, :]     # B,H,i,j,D
        below = torch.ones(n, n, dtype=torch.bool, device=r.device).tril(-1)
        expo = expo.masked_fill(~below[:, :, None], float("-inf"))
        att = torch.einsum("bhic,bhjc,bhijc->bhij", rc, kc, torch.exp(expo))
        o = o + att @ vc
        o = o + (rc * u[None, :, None, :] * kc).sum(-1, keepdim=True) * vc
        out[:, :, t0:t0 + n] = o
        last = c[:, :, -1:]
        state = (torch.exp(last).transpose(2, 3) * state
                 + torch.einsum("bhjc,bhjv->bhcv", kc * torch.exp(last - c),
                                vc))
    return out.transpose(1, 2)


def hidden(weights, cfg, tokens: torch.Tensor, fp8: bool = False):
    """Final-normed hidden states (B, S, d) float32 of ``tokens`` (B, S)."""
    b, s = tokens.shape
    d = cfg["d_model"]
    h = heads(cfg)
    kind = cfg.get("norm", "layernorm")
    x = embed(weights["embed.table"], tokens)
    for i in range(cfg["n_layers"]):
        p = f"blocks.{i}.rwkv."

        def w(name):
            return weights[p + name]

        a = norm(kind, x, weights[f"blocks.{i}.ln1.scale"])
        a_prev = shift(a)

        def mix(name):
            mu = w(name)
            return a * (1 - mu) + a_prev * mu

        r = product(mix("mu_r"), w("w_r"), fp8)
        k = product(mix("mu_k"), w("w_k"), fp8)
        v = product(mix("mu_v"), w("w_v"), fp8)
        g = product(mix("mu_g"), w("w_g"), fp8)
        logw = -torch.exp(product(mix("mu_w"), w("w_w"), fp8) + w("b_w"))
        o = wkv(*(t.reshape(b, s, h, d // h) for t in (r, k, v, logw)),
                w("u_bonus").to(F32)).reshape(b, s, d)
        x = x + product(o * w("ln_x") * F.silu(g), w("w_out"), fp8)
        bn = norm(kind, x, weights[f"blocks.{i}.ln2.scale"])
        b_prev = shift(bn)
        xk = bn * (1 - w("mu_ck")) + b_prev * w("mu_ck")
        xr = bn * (1 - w("mu_cr")) + b_prev * w("mu_cr")
        kk = torch.square(F.relu(product(xk, w("w_ck"), fp8)))
        x = x + torch.sigmoid(product(xr, w("w_cr"), fp8)) * product(
            kk, w("w_cv"), fp8)
    return norm(kind, x, weights["final_norm.scale"])

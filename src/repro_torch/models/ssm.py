"""State-space sequence mixers, the twin of ``repro.models.ssm``: a
Mamba-style selective SSM (Hymba's parallel heads) and the RWKV6 "Finch"
recurrence with data-dependent decay.

Both have a full-sequence path (a loop over time on the device, O(S)
compute, O(1) state) and a single-token decode path on an explicit
recurrent state:

    mamba state:  (B, d_inner, N)
    rwkv6 state:  wkv (B, H, hd, hd) + token-shift buffers (B, d) x2

As in the reference, the Mamba depthwise causal conv is omitted (the
selective-scan core is kept), and RWKV6's low-rank token-shift LoRA is
collapsed into per-channel mixing coefficients.

The reference's ``lax.scan`` becomes :func:`_mamba_scan` and
:func:`_rwkv_scan`: the projections are computed once for the whole
sequence before the loop, as the reference does; the terms of a step that
do not depend on the state (the decay, the input and ``k v^T``) are then
computed for a chunk of steps at once (each buffer about ``CHUNK_ELEMS``
floats); the state runs through the chunk in one launch a step; and the
chunk's outputs are read off its stacked states together.  Every step
does :func:`_mamba_step`'s or :func:`_rwkv_step`'s arithmetic on the same
values, in float32, and nothing is read back to the host.  The decode
paths call those two functions themselves.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dot, param, truncated_normal_
from repro_torch.obs import trace as obs_trace
from repro_torch.sharding import batch_local, reshape, shard

F32 = torch.float32
#: Floats in each buffer that a chunk of a time loop holds (256 MiB in
#: float32); the chunk is as many steps as fit, at least one.
CHUNK_ELEMS = 1 << 26


def _chunk_steps(per_step: int) -> int:
    return max(1, CHUNK_ELEMS // max(per_step, 1))


# =============================================================== Mamba-like
class Mamba(nn.Module):
    """The reference's tree: ``w_in``, ``w_gate`` (d, di), ``w_dt`` (di,
    di), ``w_b``, ``w_c`` (di, N), ``w_out`` (di, d) in the weight dtype;
    ``b_dt`` (di,), ``a_log`` (di, N), ``d_skip`` (di,) float32."""

    def __init__(self, cfg: ModelConfig, d_inner: int = 0, device=None):
        super().__init__()
        d = cfg.d_model
        di = d_inner or 2 * d
        n = cfg.ssm_state or 16
        wd = cfg.weight_dtype()
        self.w_in = param((d, di), wd, device)
        self.w_gate = param((d, di), wd, device)
        self.w_dt = param((di, di), wd, device)
        self.b_dt = param((di,), F32, device)
        self.w_b = param((di, n), wd, device)
        self.w_c = param((di, n), wd, device)
        self.a_log = param((di, n), F32, device)
        self.d_skip = param((di,), F32, device)
        self.w_out = param((di, d), wd, device)

    def reset_parameters(self, generator) -> None:
        d, di = self.w_in.shape
        n = self.w_b.shape[1]
        for w in (self.w_in, self.w_gate):
            truncated_normal_(w, d ** -0.5, generator)
        for w in (self.w_dt, self.w_b, self.w_c, self.w_out):
            truncated_normal_(w, di ** -0.5, generator)
        with torch.no_grad():
            self.b_dt.fill_(-4.6)                  # softplus^-1(0.01)
            self.a_log.copy_(torch.log(torch.arange(
                1, n + 1, dtype=F32, device=self.a_log.device)).expand(di, n))
            self.d_skip.fill_(1.0)


def _mamba_inputs(params: Mamba, x):
    """x (..., d) -> (xin, z, dt, bmat, cmat), float32."""
    xin = _rows(dot(x, params.w_in), "mlp")
    z = _rows(dot(x, params.w_gate), "mlp")
    dt = F.softplus(_rows(dot(xin, params.w_dt), "mlp") + params.b_dt)
    return (xin, z, dt, _rows(dot(xin, params.w_b), None),
            _rows(dot(xin, params.w_c), None))


def _rows(t, last):
    """A (B, S, n) product laid out with its rows over "batch" (its
    gradient then comes back that way too: DTensor would otherwise split
    the sequence, which it cannot flatten); other ranks pass through."""
    return shard(t, "batch", None, last) if t.dim() == 3 else t


def _mamba_step(params: Mamba, state, xin_t, z_t, dt_t, b_t, c_t, a=None):
    """state: (B, di, N).  One recurrence step, float32 state; ``a`` is
    ``-exp(a_log)`` when the caller has it."""
    if a is None:
        a = -torch.exp(params.a_log)                    # (di, N)
    da = torch.exp(dt_t[..., None] * a)                 # (B, di, N)
    db = dt_t[..., None] * b_t[..., None, :]            # (B, di, N)
    state = da * state + db * xin_t[..., None]
    y = torch.einsum("bfn,bn->bf", state, c_t) + params.d_skip * xin_t
    return state, y * F.silu(z_t)


def _mamba_scan(params: Mamba, xin, z, dt, bmat, cmat):
    """The selective scan over ``_mamba_inputs``' (B, S, ...) outputs from
    a zero state -> y (B, S, di) float32."""
    b, s, di = xin.shape
    n = bmat.shape[-1]
    a = -torch.exp(params.a_log)
    state = xin.new_zeros((b, di, n))
    step = _chunk_steps(b * di * n)
    ys = []
    for t0 in range(0, s, step):
        # Time-major views of the chunk: (T, B, ...).
        xin_c, z_c, dt_c, b_c, c_c = (t[:, t0:t0 + step].transpose(0, 1)
                                      for t in (xin, z, dt, bmat, cmat))
        da = torch.exp(dt_c[..., None] * a)                    # (T, B, di, N)
        dbx = (dt_c[..., None] * b_c[..., None, :]) * xin_c[..., None]
        states = []
        for i in range(da.shape[0]):
            state = torch.addcmul(dbx[i], da[i], state)
            states.append(state)
        y = (torch.einsum("tbfn,tbn->tbf", torch.stack(states), c_c)
             + params.d_skip * xin_c)
        ys.append(y * F.silu(z_c))
    return torch.cat(ys).transpose(0, 1)


def _scan_rows(scan, params, names, ins, *extra):
    """``scan(params, *ins, *extra)`` on each device's own batch rows
    (:func:`repro_torch.sharding.batch_local`), ``params`` cut down to the
    parameters ``names`` that the scan reads: over DTensors the time loop
    then runs on local tensors."""
    def run(*t):
        own = SimpleNamespace(**dict(zip(names, t[len(ins):])))
        return scan(own, *t[:len(ins)], *extra)

    return batch_local(run, tuple(ins), tuple(getattr(params, n)
                                              for n in names))


def mamba_forward(params: Mamba, x, cfg: ModelConfig):
    """Full-sequence selective scan.  x: (B, S, d) -> (B, S, d)."""
    y = _scan_rows(_mamba_scan, params, ("a_log", "d_skip"),
                   _mamba_inputs(params, x))
    y = shard(y.to(x.dtype), "batch", None, "mlp")
    return dot(y, params.w_out).to(x.dtype)


def mamba_decode(params: Mamba, x, state, cfg: ModelConfig):
    """One-token decode.  x: (B, 1, d); state: (B, di, N) ->
    (out (B, 1, d), new state)."""
    state, y = _scan_rows(_mamba_step, params, ("a_log", "d_skip"),
                          (state,) + _mamba_inputs(params, x[:, 0]))
    out = dot(y.to(x.dtype), params.w_out).to(x.dtype)
    return out[:, None, :], state


def mamba_state_shape(cfg: ModelConfig, batch: int, d_inner: int = 0):
    di = d_inner or 2 * cfg.d_model
    return (batch, di, cfg.ssm_state or 16)


# ==================================================================== RWKV6
_MIXES = ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "mu_ck", "mu_cr")


class RWKV6(nn.Module):
    """The reference's tree: time-mixing ``mu_{r,k,v,w,g}`` (d,), ``w_r``,
    ``w_k``, ``w_v``, ``w_w``, ``w_g``, ``w_out`` (d, d), ``b_w``,
    ``ln_x`` (d,), ``u_bonus`` (H, hd); channel-mixing ``mu_ck``,
    ``mu_cr`` (d,), ``w_ck`` (d, 3.5 d), ``w_cv`` (3.5 d, d), ``w_cr``
    (d, d).  The mixes, ``b_w``, ``ln_x`` and ``u_bonus`` are float32,
    the products in the weight dtype."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d = cfg.d_model
        h = cfg.resolved_ssm_heads
        dff = int(3.5 * d)
        wd = cfg.weight_dtype()
        for name in _MIXES:
            setattr(self, name, param((d,), F32, device))
        for name in ("w_r", "w_k", "w_v", "w_w", "w_g", "w_out", "w_cr"):
            setattr(self, name, param((d, d), wd, device))
        self.b_w = param((d,), F32, device)
        self.u_bonus = param((h, d // h), F32, device)
        self.ln_x = param((d,), F32, device)
        self.w_ck = param((d, dff), wd, device)
        self.w_cv = param((dff, d), wd, device)

    def reset_parameters(self, generator) -> None:
        d = self.w_ck.shape[0]
        for w in (self.w_r, self.w_k, self.w_v, self.w_g, self.w_out,
                  self.w_ck, self.w_cr):
            truncated_normal_(w, d ** -0.5, generator)
        truncated_normal_(self.w_w, d ** -0.5 * 0.1, generator)
        truncated_normal_(self.w_cv, (3.5 * d) ** -0.5, generator)
        truncated_normal_(self.u_bonus, 0.5, generator)
        with torch.no_grad():
            for name in _MIXES:
                getattr(self, name).fill_(0.5)
            self.b_w.fill_(-2.0)                # decay ~ exp(-exp(-2)) ~ 0.87
            self.ln_x.fill_(1.0)


def _rwkv_time_inputs(params: RWKV6, x, x_prev):
    """x/x_prev: (..., d) current and token-shifted inputs, float32 ->
    (r, k, v, g, w) float32, the decay ``w`` in (0, 1)."""
    def mix(mu):
        return x * (1 - mu) + x_prev * mu

    r = dot(mix(params.mu_r), params.w_r)
    k = dot(mix(params.mu_k), params.w_k)
    v = dot(mix(params.mu_v), params.w_v)
    g = dot(mix(params.mu_g), params.w_g)
    wraw = dot(mix(params.mu_w), params.w_w) + params.b_w
    return r, k, v, g, torch.exp(-torch.exp(wraw))


def _rwkv_heads(t, h):
    return reshape(t, t.shape[:-1] + (h, t.shape[-1] // h))


def _rwkv_step(params: RWKV6, wkv, r, k, v, w, h):
    """wkv: (B, H, hd, hd) state; r/k/v/w: (B, d) float32 -> (new wkv,
    out (B, H, hd))."""
    rh, kh, vh, wh = (_rwkv_heads(t, h) for t in (r, k, v, w))
    u = params.u_bonus
    kv = kh[..., :, None] * vh[..., None, :]                 # (B,H,hd,hd)
    out = torch.einsum("bhk,bhkv->bhv", rh, wkv + u[..., :, None] * kv)
    wkv = wh[..., :, None] * wkv + kv
    return wkv, out


def _rwkv_scan(params: RWKV6, r, k, v, w, h: int):
    """The wkv recurrence over (B, S, d) float32 inputs from a zero state
    -> out (B, S, d) float32."""
    b, s, d = r.shape
    hd = d // h
    u = params.u_bonus[..., :, None]                         # (H, hd, 1)
    wkv = r.new_zeros((b, h, hd, hd))
    step = _chunk_steps(b * h * hd * hd)
    outs = []
    for t0 in range(0, s, step):
        rc, kc, vc, wc = (_rwkv_heads(t[:, t0:t0 + step].transpose(0, 1), h)
                          for t in (r, k, v, w))             # (T, B, H, hd)
        kv = kc[..., :, None] * vc[..., None, :]             # (T,B,H,hd,hd)
        decay = wc[..., :, None]
        states = []                   # the state each step starts from
        for i in range(kv.shape[0]):
            states.append(wkv)
            wkv = torch.addcmul(kv[i], decay[i], wkv)
        outs.append(torch.einsum("tbhk,tbhkv->tbhv", rc,
                                 torch.stack(states) + u * kv))
    return reshape(torch.cat(outs).transpose(0, 1), b, s, d)


def rwkv6_time_mix(params: RWKV6, x, cfg: ModelConfig):
    """Full-sequence wkv6.  x: (B, S, d) -> (B, S, d); the time loop is
    traced as one ``ssm.rwkv_scan`` span."""
    h = cfg.resolved_ssm_heads
    x_prev = token_shift(x)
    r, k, v, g, w = _rwkv_time_inputs(params, x.float(), x_prev.float())
    with obs_trace.span("ssm.rwkv_scan"):
        out = _scan_rows(_rwkv_scan, params, ("u_bonus",), (r, k, v, w), h)
    out = out * params.ln_x * F.silu(g)
    out = shard(out.to(x.dtype), "batch", None, "mlp")
    return dot(out, params.w_out).to(x.dtype)


def token_shift(x):
    """x (B, S, d) shifted one step later in time, zeros at step 0."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def rwkv6_channel_mix(params: RWKV6, x, x_prev):
    """Squared-ReLU channel mixing with token shift."""
    xf, pf = x.float(), x_prev.float()
    xk = xf * (1 - params.mu_ck) + pf * params.mu_ck
    xr = xf * (1 - params.mu_cr) + pf * params.mu_cr
    k = torch.square(F.relu(dot(xk, params.w_ck)))
    v = dot(k, params.w_cv)
    r = torch.sigmoid(dot(xr, params.w_cr))
    return (r * v).to(x.dtype)


def rwkv6_time_decode(params: RWKV6, a, state: Dict, cfg: ModelConfig):
    """One-token time-mixing step.

    a: (B, d), the normalised block input at this step; ``state`` holds
    the wkv matrix and the previous normalised input (``x_tm``, the token
    shift).  Returns (out (B, d), new state parts)."""
    h = cfg.resolved_ssm_heads
    af = a.float()
    r, k, v, g, w = _rwkv_time_inputs(params, af, state["x_tm"])
    wkv, out = _rwkv_step(params, state["wkv"], r, k, v, w, h)
    out = reshape(out, af.shape) * params.ln_x * F.silu(g)
    y = dot(out.to(a.dtype), params.w_out).to(a.dtype)
    return y, {"wkv": wkv, "x_tm": af}


def rwkv6_channel_decode(params: RWKV6, b, x_cm):
    """One-token channel-mixing step.  b: (B, d) normalised input ->
    (out (B, d), the new shift buffer)."""
    y = rwkv6_channel_mix(params, b[:, None, :], x_cm[:, None, :])
    return y[:, 0], b.float()


def rwkv6_state_shapes(cfg: ModelConfig, batch: int) -> Dict:
    h = cfg.resolved_ssm_heads
    hd = cfg.d_model // h
    return {
        "wkv": (batch, h, hd, hd),
        "x_tm": (batch, cfg.d_model),
        "x_cm": (batch, cfg.d_model),
    }

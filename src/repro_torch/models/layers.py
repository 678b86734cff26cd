"""Core layers: norms, embeddings, MLPs, RoPE.

Plain functions on tensors, and the small ``nn.Module``s that hold their
parameters.  Parameters keep the reference's einsum layouts (an embedding
table is (vocab, d), an MLP's ``wi`` is (d, d_ff)), so weights carry across
unchanged.  Every product accumulates in float32 and returns float32
(:func:`dot`), whatever the storage type, as the reference's
``preferred_element_type=F32`` does.  :func:`dot` takes one of two routes,
by what its operands show: two bfloat16 operands, plain CUDA tensors whose
product autograd does not record, multiply on the tensor cores with a
float32 sum and result (``torch.mm(..., out_dtype=float32)``: the product of
two bfloat16 values is exact in float32); everything else (the CPU, a
float32 operand, training, DTensors) is upcast to float32 and multiplied
there.  ``DOT_TENSOR_CORE`` and ``DOT_FLOAT32`` count the two.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding import gather_weight, lookup, shard

F32 = torch.float32
BF16 = torch.bfloat16

#: Products :func:`dot` ran in this process, on the tensor cores and on
#: the float32 route; :func:`dot` adds one to either a call and nothing
#: else touches them.
DOT_TENSOR_CORE = 0
DOT_FLOAT32 = 0


def truncated_normal_(t: torch.Tensor, stddev: float,
                      generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place with ``stddev`` times a standard normal cut at
    +-2 (inverse CDF of a uniform draw from ``generator``)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.empty(t.shape, dtype=F32, device=t.device)
    u.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=generator)
    u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(stddev)
    with torch.no_grad():
        t.copy_(u)
    return t


def param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised parameter, without gradients: serving computes none,
    and the trainer turns them on for the parameters it trains."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def tensor_core_route(x: torch.Tensor, w: torch.Tensor, device_type: str,
                      distributed: bool) -> bool:
    """Whether :func:`dot` multiplies ``x`` by the 2-D ``w`` on the tensor
    cores: both bfloat16, on ``device_type`` "cuda", neither a DTensor
    (``distributed`` false), and autograd not recording the product
    (``aten::mm.dtype`` has no derivative)."""
    return (x.dtype == BF16 and w.dtype == BF16 and w.dim() == 2
            and device_type == "cuda" and not distributed
            and not (torch.is_grad_enabled()
                     and (x.requires_grad or w.requires_grad)))


def _tensor_core_mm(x2d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The tensor-core product, apart so that a CPU test (the CPU has no
    kernel for it) can stand in for it."""
    return torch.mm(x2d, w, out_dtype=F32)


def _is_dtensor(t: torch.Tensor) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated and returned in float32 (a sharded weight
    gathered first: see ``sharding.gather_weight``).  Two bfloat16
    operands that :func:`tensor_core_route` admits run on the tensor cores,
    ``x`` flattened to rows; anything else is upcast to float32 first."""
    global DOT_TENSOR_CORE, DOT_FLOAT32
    w = gather_weight(w)
    if tensor_core_route(x, w, x.device.type,
                         _is_dtensor(x) or _is_dtensor(w)):
        DOT_TENSOR_CORE += 1
        y = _tensor_core_mm(x.reshape(-1, x.shape[-1]), w)
        return y.view(*x.shape[:-1], w.shape[1])
    DOT_FLOAT32 += 1
    if x.dtype != F32 or w.dtype != F32:
        x, w = x.float(), w.float()
    return x @ w


# ------------------------------------------------------------------- norms
class Norm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = param((d,), F32, device)

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)


def rms_norm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layer_norm(x, scale, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def apply_norm(kind: str, norm: Norm, x):
    if kind == "rmsnorm":
        return rms_norm(x, norm.scale)
    return layer_norm(x, norm.scale)


# -------------------------------------------------------------- embeddings
class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, dtype, device=None):
        super().__init__()
        self.table = param((vocab, d), dtype, device)

    def reset_parameters(self, generator) -> None:
        truncated_normal_(self.table, 1.0, generator)


class Unembed(nn.Module):
    def __init__(self, d: int, vocab: int, dtype, device=None):
        super().__init__()
        self.kernel = param((d, vocab), dtype, device)

    def reset_parameters(self, generator) -> None:
        truncated_normal_(self.kernel, self.kernel.shape[0] ** -0.5, generator)


def embed(table, ids, scale: bool = False):
    x = lookup(table, ids.long())
    if scale:
        x = x * torch.tensor(table.shape[1] ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def _softcap(logits, softcap: float):
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def unembed(x, kernel, softcap: float = 0.0):
    return _softcap(dot(x, kernel), softcap)


def tied_unembed(x, table, softcap: float = 0.0):
    return _softcap(dot(x, table.T), softcap)


# --------------------------------------------------------------------- MLP
class MLP(nn.Module):
    def __init__(self, d: int, d_ff: int, activation: str, dtype, device=None):
        super().__init__()
        self.activation = activation
        self.wi = param((d, d_ff), dtype, device)
        self.wo = param((d_ff, d), dtype, device)
        self.wi_gate = (param((d, d_ff), dtype, device)
                        if activation in ("swiglu", "geglu") else None)

    def reset_parameters(self, generator) -> None:
        d, d_ff = self.wi.shape
        truncated_normal_(self.wi, d ** -0.5, generator)
        truncated_normal_(self.wo, d_ff ** -0.5, generator)
        if self.wi_gate is not None:
            truncated_normal_(self.wi_gate, d ** -0.5, generator)

    def forward(self, x):
        return mlp(x, self.wi, self.wi_gate, self.wo, self.activation)


def mlp(x, wi, wi_gate, wo, activation: str):
    h = dot(x, wi)
    if activation == "swiglu":
        h = F.silu(dot(x, wi_gate)) * h
    elif activation == "geglu":
        h = F.gelu(dot(x, wi_gate), approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    h = h.to(x.dtype)
    if h.dim() == 3:
        h = shard(h, "batch", None, "mlp")
        return shard(dot(h, wo).to(x.dtype), "batch", None, "embed")
    return dot(h, wo).to(x.dtype)


# -------------------------------------------------------------------- RoPE
def rope_angles(positions, head_dim: int, theta: float):
    """positions: (..., S) integer -> (cos, sin) of shape (..., S, head_dim/2)."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=F32,
                                          device=positions.device) / half))
    ang = positions.to(F32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., S, H, head_dim); cos/sin: (..., S, half) broadcast over H.

    Rotates the two halves of the head (not interleaved pairs)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c = cos.unsqueeze(-2).float()
    s = sin.unsqueeze(-2).float()
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)

"""Plain float32 pieces that the family references share.

Nothing here imports the program: the references are written from the
equations that ``repro``'s models state (``src/repro/models/``), so that
they witness the port rather than repeat it.  Every product runs in
float32 with TF32 off (:func:`exact_matmul`), unless ``fp8`` asks for the
control: both inputs of a product rounded to float8 e4m3 first, the input
by rows and the weight by columns, each scaled to its own largest
magnitude, then multiplied in float32.
"""

from __future__ import annotations

import contextlib

import torch

F32 = torch.float32
E4M3 = torch.float8_e4m3fn
E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_matmul():
    """float32 products in float32 (TF32 off) inside the block; the
    settings that were there are put back after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` (float32) rounded to e4m3, scaled so that the largest
    magnitude along ``dim`` maps to e4m3's largest; returned in float32."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (t / scale).to(E4M3).to(F32) * scale


def product(x: torch.Tensor, w: torch.Tensor, fp8: bool = False
            ) -> torch.Tensor:
    """``x (..., k) @ w (k, n)`` in float32; with ``fp8`` the control's
    rounding first."""
    x, w = x.to(F32), w.to(F32)
    if fp8:
        x, w = fp8_round(x, -1), fp8_round(w, 0)
    return x @ w


def layer_norm(x, scale, eps: float = 1e-5):
    """Layer norm without a shift, as ``repro``'s ``layer_norm``."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale.to(F32)


def rms_norm(x, scale, eps: float = 1e-6):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.to(F32)


def norm(kind: str, x, scale):
    return rms_norm(x, scale) if kind == "rmsnorm" else layer_norm(x, scale)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()].to(F32)


def final_logits(weights, cfg, h: torch.Tensor, fp8: bool = False):
    """Logits (n, V) of final-normed hidden rows ``h`` (n, d)."""
    if cfg.get("tie_embeddings"):
        return product(h, weights["embed.table"].T, fp8)
    return product(h, weights["unembed.kernel"], fp8)

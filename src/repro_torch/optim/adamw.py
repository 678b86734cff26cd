"""AdamW, the twin of ``repro.optim.adamw``.

* moment dtype is configurable (float32 by default; bfloat16 halves the
  optimizer's memory);
* the optimizer state mirrors the parameters: ``mu`` and ``nu`` are dicts
  with the parameters' names;
* global-norm clipping, the optional int8 stochastic-rounding gradient
  compression, the moments and the decoupled weight decay are one pass
  over the parameters.

The update writes the parameters and the moments in place (the
reference's donated buffers) and returns them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.sharding import distribute_like, whole

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    moment_dtype: str = "float32"      # "bfloat16" halves optimizer memory
    compress_grads: bool = False        # int8 gradient compression (study knob)


def adamw_init(params: Mapping[str, torch.Tensor], cfg: AdamWConfig) -> Dict:
    """Zero moments, each laid out as its parameter (a DTensor's on each
    rank as its own part)."""
    mdt = getattr(torch, cfg.moment_dtype)
    dev = next(iter(params.values())).device

    def zeros():
        return {n: torch.zeros_like(p, dtype=mdt) for n, p in params.items()}

    return {"mu": zeros(), "nu": zeros(),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def _global_norm(grads) -> torch.Tensor:
    # Each gradient's rows first, then their norms: no full-size
    # temporary, a sharded (DTensor) gradient is not gathered, and float32
    # sums stay short (one pass over 311 M values drifts by 4e-3 on a CPU).
    # A DTensor's norm is reduced over the ranks (one all-reduce of a
    # scalar a leaf), so the result is a plain tensor, the same on each.
    norm = torch.linalg.vector_norm
    return norm(torch.stack([whole(norm(norm(g, dim=-1, dtype=F32)))
                             for g in grads]))


def _compress_int8(g: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Stochastic-rounding int8 quantise/dequantise (per-tensor scale);
    ``noise`` is uniform in [-0.5, 0.5), of ``g``'s shape."""
    gf = g.float()
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale + noise), -127, 127)
    return (q * scale).to(g.dtype)


@torch.no_grad()
def adamw_update(
    params: Mapping[str, torch.Tensor],
    grads: Mapping[str, torch.Tensor],
    state: Dict,
    cfg: AdamWConfig,
    lr: Optional[torch.Tensor] = None,
    decay: Optional[Mapping[str, bool]] = None,
    noise: Optional[Mapping[str, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Mapping[str, torch.Tensor], Dict]:
    """One fused AdamW step (clip -> [compress] -> moments -> decayed
    update), in place.

    ``decay[name]`` says whether a parameter is decayed; by default those
    of rank 2 or more are (norm scales and biases are not).  With
    ``compress_grads``, ``noise[name]`` is the rounding noise of each
    gradient; without it the noise is drawn from ``generator`` (seeded 0
    on the parameters' device when not given): the reference draws its
    noise through threefry, which a ``torch.Generator`` cannot reproduce.
    The noise is drawn at a gradient's global shape and laid out as the
    gradient, so a sharded run rounds as the one-device run does.
    """
    lr = cfg.lr if lr is None else lr
    names = list(params)
    if cfg.compress_grads:
        if noise is None:
            dev = params[names[0]].device
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            noise = {n: torch.rand(grads[n].shape, generator=generator,
                                   dtype=F32, device=dev) - 0.5
                     for n in names}
        grads = {n: _compress_int8(grads[n],
                                   distribute_like(noise[n], grads[n]))
                 for n in names}

    gnorm = _global_norm([grads[n] for n in names])
    clip = torch.clamp(cfg.grad_clip_norm / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    count = state["count"] + 1
    cf = count.to(F32)
    c1 = 1.0 - torch.pow(cfg.b1, cf)
    c2 = 1.0 - torch.pow(cfg.b2, cf)
    mus, nus = state["mu"], state["nu"]
    # In place, with two float32 scratch tensors a parameter, each product
    # and sum rounded where the reference's expression rounds it.
    for n in names:
        p, mu, nu = params[n], mus[n], nus[n]
        gf = grads[n].float() * clip
        t = gf * (1 - cfg.b1)
        mu_f = mu.float().mul_(cfg.b1).add_(t)        # b1 mu + (1 - b1) g
        torch.mul(gf, 1 - cfg.b2, out=t).mul_(gf)
        nu_f = nu.float().mul_(cfg.b2).add_(t)        # b2 nu + (1 - b2) g g
        denom = torch.div(nu_f, c2, out=gf).sqrt_().add_(cfg.eps)
        step = torch.div(mu_f, c1, out=t).div_(denom)
        p32 = p.float()
        if (p.dim() >= 2) if decay is None else decay[n]:
            step.add_(torch.mul(p32, cfg.weight_decay, out=gf))
        step.mul_(lr)
        if p32 is p:
            p.sub_(step)
        else:
            p.copy_(p32.sub_(step))
        if mu_f is not mu:
            mu.copy_(mu_f)
            nu.copy_(nu_f)
    return params, {"mu": mus, "nu": nus, "count": count}

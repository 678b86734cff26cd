"""A configuration's weights, drawn from a seed on the device.

The benchmark makes the weights; the port and the reference are handed
the same draw.  Each family's reference module lists its parameters
(``param_specs``) under the port's names, with shape, dtype and how each
is drawn.  The draw is two large calls, one standard normal over every
bfloat16 parameter and one over every float32 one, each from one
``torch.Generator`` on the device seeded with ``seed``; each parameter is
then a view of its buffer, scaled in place:

    ("normal", mean, std)   mean + std * z
    ("sigmoid",)            sigmoid(z), a mixing coefficient in (0, 1)
"""

from __future__ import annotations

import importlib
from typing import Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def family_module(cfg):
    return importlib.import_module(f"portbench.reference.{cfg['family']}")


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def draw(cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> tensor on ``device``, the same for the same seed."""
    table = family_module(cfg).param_specs(cfg)
    gen = generator(seed, device)
    out = {}
    for dname in ("bfloat16", "float32"):
        names = [n for n, (_s, dt, _i) in table.items() if dt == dname]
        sizes = [torch.Size(table[n][0]).numel() for n in names]
        if not names:
            continue
        flat = torch.randn(sum(sizes), dtype=DTYPES[dname], device=device,
                           generator=gen)
        off = 0
        for name, size in zip(names, sizes):
            t = flat[off:off + size].view(table[name][0])
            off += size
            init = table[name][2]
            if init[0] == "normal":
                t.mul_(init[2]).add_(init[1])
            elif init[0] == "sigmoid":
                t.sigmoid_()
            else:
                raise ValueError(f"{name}: unknown init {init!r}")
            out[name] = t
    return out

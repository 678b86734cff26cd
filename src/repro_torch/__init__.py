"""PyTorch/CUDA port of the SYNPA thread-to-core allocation system and of
its language-model serving path.

The package mirrors ``repro`` module for module (``repro_torch.core.isc``
is the twin of ``repro.core.isc``, and so on).  It imports ``torch`` and
numpy only: it keeps its own copies of the numpy-only modules it needs.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU they raise rather than carry on quietly on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` says
    otherwise.  Raises when CUDA is asked for (or defaulted to) and no GPU
    is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def to_device(x, dtype, device) -> torch.Tensor:
    """A host array as a ``dtype`` tensor on ``device``, without a host
    sync: on a GPU the copy goes through page-locked memory, queued on the
    current stream (the caching host allocator keeps the buffer until the
    copy is done).  A tensor already on a GPU is only moved and cast; a
    DTensor (rows already on its ranks' devices) is only cast."""
    if hasattr(x, "placements"):
        return x.to(dtype)
    if isinstance(x, torch.Tensor) and x.device.type != "cpu":
        return x.to(device=device, dtype=dtype)
    t = torch.as_tensor(np.ascontiguousarray(x)).to(dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)

"""PyTorch/CUDA port of the SYNPA thread-to-core allocation system.

The package mirrors ``repro`` module for module (``repro_torch.core.isc``
is the twin of ``repro.core.isc``, and so on).  It imports ``torch`` and
numpy only: it keeps its own copies of the numpy-only modules it needs.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU they raise rather than carry on quietly on the CPU.
"""

from __future__ import annotations

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

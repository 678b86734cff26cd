"""The four input-shape suites of the LM family, the twin of
``repro.configs.shapes``.

``train_4k`` traces ``train_step``; ``prefill_32k`` the full-sequence
``forward``; ``decode_*`` / ``long_*`` ``decode_step``: one new token
against a KV cache or recurrent state of ``seq_len``.

``long_500k`` requires sub-quadratic attention: it runs only for the SSM and
hybrid architectures.
"""

from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def shapes_for(cfg: ModelConfig) -> List[InputShape]:
    """The shape cells assigned to an architecture (with documented skips)."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.sub_quadratic:
        out.append(SHAPES["long_500k"])
    return out

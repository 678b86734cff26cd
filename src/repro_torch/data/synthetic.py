"""Deterministic synthetic data pipeline, a numpy copy of
``repro.data.synthetic``: the same batches, bit for bit.

Produces next-token-predictable token streams (orderic mixtures of n-gram
chains) so a small model trained for a few hundred steps shows a cleanly
falling loss.  ``host_batch(step, host_id, n_hosts)`` returns one host's
slice of the global batch, derived from (seed, step, host), so any host
can recompute any batch and a resumed run needs no iterator state.
:func:`make_batch_specs` gives the dry-run's stand-ins for a batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    order: int = 2          # markov order of the synthetic chain

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        # sparse deterministic transition: token -> token (order-1 view)
        self._next = rng.integers(0, v, size=v, dtype=np.int64)
        self._skip = rng.integers(0, v, size=v, dtype=np.int64)

    def _stream(self, rng: np.random.Generator, length: int) -> np.ndarray:
        v = self.vocab_size
        out = np.empty(length, np.int64)
        t = int(rng.integers(0, v))
        for i in range(length):
            out[i] = t
            # mostly-deterministic chain with occasional random restart
            r = rng.random()
            if r < 0.85:
                t = int(self._next[t])
            elif r < 0.95:
                t = int(self._skip[t])
            else:
                t = int(rng.integers(0, v))
        return out

    def global_batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The (tokens, labels) global batch for ``step`` (deterministic)."""
        toks = np.stack(
            [self._stream(np.random.default_rng((self.seed, step, b)),
                          self.seq_len + 1)
             for b in range(self.global_batch)]
        )
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def host_batch(self, step: int, host_id: int, n_hosts: int
                   ) -> Dict[str, np.ndarray]:
        if self.global_batch % n_hosts:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {n_hosts} hosts")
        per = self.global_batch // n_hosts
        full = self.global_batch_at(step)
        sl = slice(host_id * per, (host_id + 1) * per)
        return {k: v[sl] for k, v in full.items()}


def make_batch_specs(cfg, seq_len: int, global_batch: int,
                     kind: str) -> Dict[str, torch.Tensor]:
    """``meta`` tensors standing in for every model input of a dry-run
    cell: int32 ``tokens`` (and ``labels`` to train), for the vlm
    ``image_embeds`` and for audio ``audio_frames`` in the activation
    dtype.  Nothing is allocated."""
    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    i32 = torch.int32
    dt = cfg.activation_dtype()
    if kind == "train":
        specs = {"tokens": spec((global_batch, seq_len), i32),
                 "labels": spec((global_batch, seq_len), i32)}
    elif kind == "prefill":
        specs = {"tokens": spec((global_batch, seq_len), i32)}
    elif kind == "decode":
        specs = {"tokens": spec((global_batch, 1), i32)}
    else:
        raise ValueError(kind)
    if cfg.family == "vlm" and kind in ("train", "prefill"):
        specs["image_embeds"] = spec(
            (global_batch, cfg.n_image_tokens, cfg.d_model), dt)
    if cfg.family == "audio" and kind in ("train", "prefill"):
        specs["audio_frames"] = spec(
            (global_batch, cfg.encoder_seq, cfg.d_model), dt)
    return specs

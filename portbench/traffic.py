"""The one traffic generator: a mix's data file in, a seeded schedule out.

A mix is ``portbench/traffic/<name>.json``.  Its ``entry`` names the
runner under ``portbench/entries/`` that feeds the schedule to the port;
the other keys are the mix's parameters:

    prefill   batch, lengths: closed-loop prefill batches of ``batch``
              sequences of one length; the lengths come in cycles, each
              cycle every length once in an order drawn from the seed
    generate  slots, max_len, requests_per_call, prompt_min, prompt_max,
              max_new_tokens: closed-loop calls of ``generate``, each a
              queue of ``requests_per_call`` prompts whose lengths are
              spread evenly over [prompt_min, prompt_max], in one fixed
              shuffled order: the order decides which requests share a
              slot, and so how many steps a call takes

Both draw token ids uniformly from the configuration's vocabulary from
the seed, and give every seed the same work: the same sizes, in a
prefill cycle in another order (a cycle's work does not depend on it).  ``check`` (a count) says how much of
what the window produced the comparison samples.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def load(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one purpose (``stream``) of one seed."""
    return np.random.default_rng([int(seed) % (1 << 63), stream])


#: Streams of :func:`rng`.
TRAFFIC, WARMUP, SAMPLE = 1, 2, 3
#: The seed of the generate mixes' one order of prompt lengths.
LENGTH_ORDER = 0


class Prefill:
    """Batches (B, S) of token ids, in cycles of the mix's lengths."""

    def __init__(self, mix: dict, vocab: int, seed: int,
                 stream: int = TRAFFIC):
        self.batch = int(mix["batch"])
        self.lengths = [int(s) for s in mix["lengths"]]
        self.vocab = vocab
        self._rng = rng(seed, stream)

    def cycle(self):
        """One cycle: a list of (B, S) int32 arrays, each length once."""
        order = self._rng.permutation(len(self.lengths))
        return [self._rng.integers(0, self.vocab,
                                   (self.batch, self.lengths[i]),
                                   dtype=np.int32) for i in order]


class Generate:
    """Queues of prompts for ``ServeEngine.generate``."""

    def __init__(self, mix: dict, vocab: int, seed: int,
                 stream: int = TRAFFIC):
        self.mix = mix
        self.vocab = vocab
        self._rng = rng(seed, stream)
        n = int(mix["requests_per_call"])
        lo, hi = int(mix["prompt_min"]), int(mix["prompt_max"])
        #: The same lengths in the same order in every call and for every
        #: seed: [lo, hi] spread evenly, shuffled once.
        self.lengths = np.random.default_rng(LENGTH_ORDER).permutation(
            lo + (np.arange(n) * (hi - lo + 1)) // n)

    def call(self):
        """One call's prompts: a list of 1-D int32 arrays."""
        return [self._rng.integers(0, self.vocab, (int(s),), dtype=np.int32)
                for s in self.lengths]

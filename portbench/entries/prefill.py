"""Closed-loop prefill: ``ServeEngine.prefill`` on batches back to back.

The window runs whole cycles of the mix's lengths (:class:`traffic.
Prefill`), so that every run weighs the lengths alike, and starts another
while the time left is at least half a cycle: it lasts ``seconds`` to
within half a cycle.  Of each batch's logits (B, S, V) the
window keeps the greedy choice at every position, the answer that the
comparison judges; the logits themselves are dropped.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import traffic
from portbench.counts import model_step

#: Cycles made before the window opens; more are made if it needs them.
CYCLES_AHEAD = 8


class Runner:
    def __init__(self, model, cfg: dict, mix: dict, seed: int, device):
        from repro_torch.serve.engine import ServeEngine

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.engine = ServeEngine(model, max_len=max(mix["lengths"]),
                                  batch_size=int(mix["batch"]))
        self.traffic = traffic.Prefill(mix, cfg["vocab_size"], seed)
        self.batches = []        # (tokens (B, S) host, choices (B, S) device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _one(self, tokens):
        with record_function("portbench.prefill"):
            logits = self.engine.prefill({"tokens": tokens})
        with record_function("portbench.choices"):
            return logits.argmax(-1)

    def warmup(self):
        """One batch of each length, from data the window never sees."""
        warm = traffic.Prefill(self.mix, self.cfg["vocab_size"], self.seed,
                               stream=traffic.WARMUP)
        for tokens in warm.cycle():
            self._one(tokens)
        self._sync()

    def window(self, seconds: float) -> dict:
        cycles = [self.traffic.cycle() for _ in range(CYCLES_AHEAD)]
        self._sync()
        t0 = time.perf_counter()
        done = 0
        while True:
            cycle = cycles.pop(0) if cycles else self.traffic.cycle()
            for tokens in cycle:
                self.batches.append((tokens, self._one(tokens)))
            self._sync()
            done += 1
            elapsed = time.perf_counter() - t0
            if seconds - elapsed < 0.5 * elapsed / done:
                break
        shapes = [t.shape for t, _ in self.batches]
        return {
            "seconds": elapsed,
            "prefill_tokens": int(sum(b * s for b, s in shapes)),
            "attempted": int(sum(b for b, _ in shapes)),
            "failed": 0,
            "model_flops": float(sum(model_step.prefill_flops(self.cfg, b, s)
                                     for b, s in shapes)),
            "batches": [list(s) for s in shapes],
        }

    def traced(self, win) -> dict:
        """One more cycle, of new data, inside the profiler's window."""
        cycle = self.traffic.cycle()
        win.start()
        for tokens in cycle:
            self._one(tokens)
        win.stop()
        return {"batches": [list(t.shape) for t in cycle]}

    def samples(self, count: int):
        """The comparison's sample: a batch of the longest length and
        ``count - 1`` others, drawn from the seed; every position of
        every sequence in them, with the window's choice there."""
        rng = traffic.rng(self.seed, traffic.SAMPLE)
        longest = max(t.shape[1] for t, _ in self.batches)
        tops = [i for i, (t, _) in enumerate(self.batches)
                if t.shape[1] == longest]
        picked = [int(rng.choice(tops))]
        rest = [i for i in range(len(self.batches)) if i not in picked]
        picked += [int(i) for i in rng.choice(
            rest, size=min(count - 1, len(rest)), replace=False)]
        out = []
        for i in picked:
            tokens, choices = self.batches[i]
            choices = choices.cpu().numpy()
            for row in range(tokens.shape[0]):
                out.append({"tokens": tokens[row],
                            "positions": np.arange(tokens.shape[1]),
                            "chosen": choices[row]})
        return out

"""Closed-loop batched generation: ``ServeEngine.generate`` calls back to
back.

Each call is a queue of the mix's prompts (:class:`traffic.Generate`),
greedy, with no end token, so that every request gets exactly
``max_new_tokens``; the window runs whole calls, and starts another
while the time left is at least half a call: it lasts ``seconds`` to
within half a call.  The harness wraps the engine's ``serve_step`` from here to time
each decode step (the host clock at each step's start) and to open and
close the profiler's window inside a call.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import traffic
from portbench.counts import model_step

#: Calls whose prompts are made before the window opens.
CALLS_AHEAD = 6
#: The traced window: decode steps ``TRACE_FROM`` to ``TRACE_FROM +
#: TRACE_STEPS`` of one call, all slots busy.
TRACE_FROM, TRACE_STEPS = 16, 32


class _TraceDone(Exception):
    """Ends the traced call once its window has closed."""


class Runner:
    def __init__(self, model, cfg: dict, mix: dict, seed: int, device):
        from repro_torch.serve.engine import ServeEngine

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.engine = ServeEngine(model, max_len=int(mix["max_len"]),
                                  batch_size=int(mix["slots"]))
        self.traffic = traffic.Generate(mix, cfg["vocab_size"], seed)
        self.calls = []          # (prompts, outputs) of the window's calls
        self._stamps = None      # step start times of the running call
        self._hook = None        # called with the step index before a step
        step = self.engine.serve_step

        def timed(cache, tokens):
            if self._hook is not None:
                self._hook(len(self._stamps))
            self._stamps.append(time.perf_counter())
            return step(cache, tokens)

        self.engine.serve_step = timed

    def _generate(self, prompts, max_new: int):
        self._stamps = []
        outs = self.engine.generate(prompts, max_new_tokens=max_new,
                                    eos_id=-1, greedy=True)
        return outs, self._stamps

    def warmup(self):
        """Two requests a slot of one token each: the decode step at its
        full batch, a slot reset, and the host loop."""
        warm = traffic.rng(self.seed, traffic.WARMUP)
        prompts = [warm.integers(0, self.cfg["vocab_size"], (1,),
                                 dtype=np.int32)
                   for _ in range(2 * int(self.mix["slots"]))]
        self._generate(prompts, 1)

    def window(self, seconds: float) -> dict:
        queued = [self.traffic.call() for _ in range(CALLS_AHEAD)]
        max_new = int(self.mix["max_new_tokens"])
        intervals, steps = [], 0
        t0 = time.perf_counter()
        while True:
            prompts = queued.pop(0) if queued else self.traffic.call()
            outs, stamps = self._generate(prompts, max_new)
            self.calls.append((prompts, outs))
            intervals += list(np.diff(stamps))
            steps += len(stamps)
            elapsed = time.perf_counter() - t0
            if seconds - elapsed < 0.5 * elapsed / len(self.calls):
                break
        prompts = [p for ps, _ in self.calls for p in ps]
        outs = [o for _, os_ in self.calls for o in os_]
        # Each request feeds its prompt and all but its last new token.
        positions = [p for pr, o in zip(prompts, outs)
                     for p in range(len(pr) + len(o) - 1)]
        return {
            "seconds": elapsed,
            "generated_tokens": int(sum(len(o) for o in outs)),
            "attempted": len(prompts),
            "failed": int(sum(len(o) != max_new for o in outs)),
            "model_flops": float(model_step.decode_flops(self.cfg, positions)),
            "step_intervals_s": [float(x) for x in intervals],
            "steps": steps,
        }

    def traced(self, win) -> dict:
        """Steps ``TRACE_FROM`` .. of a call of new prompts, profiled (up
        to the call's end, where it has fewer steps)."""
        end = TRACE_FROM + TRACE_STEPS
        seen = []

        def hook(i):
            seen.append(i)
            if i == TRACE_FROM:
                win.start()
            elif i == end:
                win.stop()
                raise _TraceDone

        self._hook = hook
        try:
            self._generate(self.traffic.call(),
                           int(self.mix["max_new_tokens"]))
        except _TraceDone:
            pass
        finally:
            self._hook = None
        last = seen[-1] if seen else -1
        if TRACE_FROM <= last < end:      # the call ended inside the window
            win.stop()
            return {"steps": last + 1 - TRACE_FROM}
        if last < TRACE_FROM:             # too short a call to trace
            win.start()
            win.stop()
            return {"steps": 0}
        return {"steps": TRACE_STEPS}

    def samples(self, count: int):
        """The comparison's sample, drawn from the seed: the request with
        the longest prompt, half of the rest from requests that took a
        slot someone had used before in its call, the others from any
        call.  Each is its prompt and its tokens but the last, with the
        served token judged at each position from the prompt's last on."""
        rng = traffic.rng(self.seed, traffic.SAMPLE)
        slots = int(self.mix["slots"])
        reqs = [(p, o, i >= slots) for ps, os_ in self.calls
                for i, (p, o) in enumerate(zip(ps, os_))]
        longest = max(len(p) for p, _, _ in reqs)
        first = int(rng.choice([i for i, r in enumerate(reqs)
                                if len(r[0]) == longest]))
        reused = [i for i, r in enumerate(reqs) if r[2] and i != first]
        n_reused = min((count - 1) // 2, len(reused))
        picked = [first] + [int(i) for i in rng.choice(reused, n_reused,
                                                       replace=False)]
        rest = [i for i in range(len(reqs)) if i not in picked]
        picked += [int(i) for i in rng.choice(
            rest, min(count - len(picked), len(rest)), replace=False)]
        out = []
        for i in picked:
            prompt, toks, _ = reqs[i]
            toks = np.asarray(toks, np.int64)
            out.append({
                "tokens": np.concatenate([prompt, toks[:-1]]).astype(np.int64),
                "positions": len(prompt) - 1 + np.arange(len(toks)),
                "chosen": toks,
            })
        return out

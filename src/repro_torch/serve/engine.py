"""Serving engine: prefill, decode steps and simple continuous batching.

``serve_step`` produces one new token for every slot of the batch against
the KV cache.  ``generate`` is the host-side continuous-batching loop:
finished sequences are replaced in place so the decode batch stays full
(slot reuse).  The engine runs on its model's device; parameters live in
the model, so no method takes them.

Under a mesh that ``sharding.axis_rules`` installs (``launch.serve``
inside a process group, the model laid out by ``distribute_model``) the
engine serves over it: the batch rows (slots) and the cache lie over the
"batch" rule's axes (whole on every rank where they do not divide), every
rank runs the same host loop on the same requests, and each step's new
tokens are gathered whole before they are read, so that every rank makes
the same slot decisions and returns the same outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import to_device
from repro_torch.models.transformer import Model
from repro_torch.obs import trace as obs_trace
from repro_torch.sharding import current_mesh, distribute_rows, whole


@dataclasses.dataclass
class ServeEngine:
    model: Model
    max_len: int
    batch_size: int

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _rows(self, t):
        """A whole batch-first tensor (the same on every rank) as the
        model takes it: under a mesh, a DTensor of each rank's rows."""
        mesh = current_mesh()
        return t if mesh is None else distribute_rows(t, mesh)

    def _tokens(self, arr) -> torch.Tensor:
        """Host token ids (B, S) on the device, without a host sync, in
        :meth:`_rows`' layout."""
        return self._rows(to_device(arr, torch.int32, self.device))

    # ----------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, batch, cache: Optional[Dict] = None) -> torch.Tensor:
        """Full-sequence forward of ``batch`` -> logits (B, S, V) float32:
        ``tokens`` (B, S), with ``image_embeds`` (vlm) or ``audio_frames``
        (audio), whole on every rank; attention routes on
        ``cfg.attention_impl``.  Under a mesh the logits are a DTensor, its
        rows where the batch's lie.  With latent attention a decode
        ``cache`` of B rows may be given, which the prompt fills in place
        (``Model.forward``), so that :meth:`serve_step` goes on from it."""
        with obs_trace.span("serve.prefill"):
            logits, _aux = self.model.forward(
                {k: self._rows(torch.as_tensor(v, device=self.device))
                 for k, v in batch.items()}, cache=cache)
        return logits

    @torch.no_grad()
    def prefill_into_cache(self, tokens, extras: Optional[Dict] = None):
        """Sequential prefill through decode steps (the semantics path; the
        flash prefill above is the fast one).  ``extras`` go into the cache
        (``image_embeds``, or the encoder's output ``enc``)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        b, s = tokens.shape
        cache = self.model.init_cache(b, self.max_len, extras=extras)
        logits = None
        for t in range(s):
            logits, cache = self.model.decode_step(
                cache, self._rows(tokens[:, t:t + 1]))
        return logits, cache

    # ------------------------------------------------------------- step
    @torch.no_grad()
    def serve_step(self, cache, tokens):
        """One new token for the whole running batch."""
        return self.model.decode_step(cache, tokens)

    # ---------------------------------------------- continuous batching
    def reset_slots(self, cache, slot_mask: np.ndarray):
        """Reset every True slot: its position to 0 and its recurrent
        states (``ssm``, ``rwkv``) to zeros, in new tensors.  Stale KV
        entries need no clearing: the per-slot position mask (or, in a
        ring, the written-slot mask) hides them.  A slot's
        ``image_embeds`` or ``enc`` stay as they are, as the reference's."""
        reset = to_device(np.asarray(slot_mask, bool), torch.bool, self.device)
        cache = dict(cache)
        cache["pos"] = torch.where(reset, torch.zeros_like(cache["pos"]),
                                   cache["pos"])
        keep = (~reset).float()

        def zero_state(x):             # (L, B, ...): the batch is axis 1
            return x * keep.reshape((1, -1) + (1,) * (x.dim() - 2))

        if "ssm" in cache:
            cache["ssm"] = zero_state(cache["ssm"])
        if "rwkv" in cache:
            cache["rwkv"] = {k: zero_state(v) for k, v in cache["rwkv"].items()}
        return cache

    def generate(
        self,
        prompts: List[np.ndarray],
        max_new_tokens: int = 32,
        eos_id: int = -1,
        greedy: bool = True,
        extras: Optional[Dict] = None,
        generator: Optional[torch.Generator] = None,
    ) -> List[np.ndarray]:
        """Continuous-batching host loop over ``batch_size`` decode slots.

        Requests queue up; whenever a slot finishes (EOS or token budget) it
        is reset and the next queued prompt streams in while the other
        slots keep decoding.  Sampling (``greedy=False``) draws from
        ``generator``, a ``torch.Generator`` on the model's device (seeded
        0 when not given), over the whole batch's logits: under a mesh
        every rank draws the same tokens from its own generator seeded
        alike, those of one process.

        Traced (:mod:`repro_torch.obs.trace`): one ``serve.generate`` span
        a call, its args ``steps``, ``token_reads`` (one a step, the only
        time the loop waits for the device), ``slot_resets`` (slots reset
        for a new request) and ``requests``; one ``serve.step`` a decode
        step, with the children ``serve.feed``, ``serve.decode``,
        ``serve.token_read``, ``serve.bookkeep`` and, on steps that reset a
        slot, ``serve.reset_slots``; and one ``serve.request`` a request,
        from the call's start (its enqueue) to the read of its last token,
        its args ``rid``, ``call`` (the ``serve.generate`` span's id),
        ``slot``, ``prompt_len``, ``new_tokens``, ``slot_ns`` (when it took
        its slot) and ``first_token_ns``, stamped with the step's one
        clock read after its token read.
        """
        if not greedy and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        tracing = obs_trace.enabled()
        with obs_trace.span("serve.generate") as call:
            t_now = obs_trace.now_ns() if tracing else 0
            t_call = t_now
            queue = list(enumerate(prompts))
            results: Dict[int, List[int]] = {}
            # rid -> [slot, prompt_len, slot_ns, first_token_ns], traced.
            reqs: Dict[int, List[int]] = {}
            b = self.batch_size
            cache = self.model.init_cache(b, self.max_len, extras=extras)
            slot_req = [-1] * b               # request id per slot
            slot_left = [0] * b               # generation budget left
            feed: List[List[int]] = [[] for _ in range(b)]
            cur = np.zeros((b, 1), np.int32)
            steps = token_reads = slot_resets = 0

            def assign(slot: int) -> bool:
                if not queue:
                    slot_req[slot] = -1
                    feed[slot] = []
                    return False
                rid, prompt = queue.pop(0)
                slot_req[slot] = rid
                slot_left[slot] = max_new_tokens
                results[rid] = []
                feed[slot] = [int(t) for t in prompt]
                if tracing:
                    reqs[rid] = [slot, len(feed[slot]), t_now, 0]
                return True

            for s in range(b):
                assign(s)

            while any(r >= 0 for r in slot_req):
                with obs_trace.span("serve.step"):
                    with obs_trace.span("serve.feed"):
                        step_tok = np.zeros((b, 1), np.int32)
                        feeding = [False] * b
                        for s in range(b):
                            if feed[s]:
                                step_tok[s, 0] = feed[s].pop(0)
                                feeding[s] = True
                            else:
                                step_tok[s, 0] = cur[s, 0]
                        tokens = self._tokens(step_tok)
                    with obs_trace.span("serve.decode"):
                        logits, cache = self.serve_step(cache, tokens)
                    with obs_trace.span("serve.token_read"):
                        last = logits[:, -1]
                        if greedy:
                            nxt = whole(torch.argmax(last, dim=-1))
                        else:
                            nxt = torch.multinomial(
                                torch.softmax(whole(last).float(), dim=-1),
                                1, generator=generator)[:, 0]
                        nxt = nxt.cpu().numpy()
                        token_reads += 1
                        if tracing:
                            t_now = obs_trace.now_ns()
                    steps += 1
                    with obs_trace.span("serve.bookkeep"):
                        reset_mask = np.zeros(b, bool)
                        for s in range(b):
                            rid = slot_req[s]
                            if rid < 0:
                                continue
                            if feeding[s] and feed[s]:
                                continue       # still streaming the prompt
                            out = results[rid]
                            out.append(int(nxt[s]))
                            if tracing and len(out) == 1:
                                reqs[rid][3] = t_now
                            slot_left[s] -= 1
                            if slot_left[s] <= 0 or int(nxt[s]) == eos_id:
                                if tracing:
                                    slot, plen, t_slot, t_first = reqs[rid]
                                    obs_trace.record(
                                        "serve.request", t_call, t_now,
                                        rid=rid, call=call.id, slot=slot,
                                        prompt_len=plen, new_tokens=len(out),
                                        slot_ns=t_slot, first_token_ns=t_first)
                                if assign(s):
                                    reset_mask[s] = True  # new request
                    if reset_mask.any():
                        with obs_trace.span("serve.reset_slots"):
                            cache = self.reset_slots(cache, reset_mask)
                        slot_resets += int(reset_mask.sum())
                    cur = nxt[:, None].astype(np.int32)
            call.set(steps=steps, token_reads=token_reads,
                     slot_resets=slot_resets, requests=len(results))
        return [np.array(results[i]) for i in sorted(results)]

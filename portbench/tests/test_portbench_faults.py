"""The verdict catches a broken timed path: each fault that a cell can
have, planted under the harness at a smoke size on the CPU, makes
``correct`` false against the cell's own limit.

    token      a served token (or a prefill's choice) altered where it is
               produced: the logits of one step or position changed
    half       half of the batch left out: its rows copied from the rest
    state      a decode step that leaves the cache and states unchanged
               (generate cells; a prefill has no state across calls)

One chip, so no exchange between chips is left out.
"""

import time

import pytest
import torch

from portbench import check, harness
from portbench.tests._smoke import bench, cells, use_smoke_sizes

SEED = 4242


def _token_fault(monkeypatch):
    from repro_torch.serve.engine import ServeEngine

    prefill, step = ServeEngine.prefill, ServeEngine.serve_step
    calls = [0]

    def bad_prefill(self, batch):
        logits = prefill(self, batch)
        wrong = (logits[0, -1].argmax() + 1) % logits.shape[-1]
        logits[0, -1, wrong] = logits[0, -1].max() + 10.0
        return logits

    def bad_step(self, cache, tokens):
        logits, cache = step(self, cache, tokens)
        calls[0] += 1
        if calls[0] % 5 == 0:
            wrong = (logits[:, -1].argmax(-1) + 1) % logits.shape[-1]
            logits[torch.arange(logits.shape[0]), -1, wrong] = \
                logits.amax(dim=(1, 2)) + 10.0
        return logits, cache

    monkeypatch.setattr(ServeEngine, "prefill", bad_prefill)
    monkeypatch.setattr(ServeEngine, "serve_step", bad_step)


def _half_fault(monkeypatch):
    from repro_torch.serve.engine import ServeEngine

    prefill, step = ServeEngine.prefill, ServeEngine.serve_step

    def halve(logits):
        b = logits.shape[0]
        logits[b - b // 2:] = logits[:b // 2]
        return logits

    monkeypatch.setattr(ServeEngine, "prefill",
                        lambda self, batch: halve(prefill(self, batch)))

    def bad_step(self, cache, tokens):
        logits, cache = step(self, cache, tokens)
        return halve(logits), cache

    monkeypatch.setattr(ServeEngine, "serve_step", bad_step)


def _state_fault(monkeypatch):
    from repro_torch.models.transformer import Model

    decode = Model.decode_step

    def frozen(self, cache, tokens):
        scratch = {k: ({kk: vv.clone() for kk, vv in v.items()}
                       if isinstance(v, dict) else v.clone())
                   for k, v in cache.items()}
        logits, _ = decode(self, scratch, tokens)
        return logits, dict(cache, pos=cache["pos"] + 1)

    monkeypatch.setattr(Model, "decode_step", frozen)


FAULTS = {"token": _token_fault, "half": _half_fault, "state": _state_fault}


def _cases():
    for cell in cells():
        for fault in FAULTS:
            if fault == "state" and "generate" not in cell:
                continue
            yield cell, fault


def _run(tmp_path, monkeypatch, cell):
    use_smoke_sizes(tmp_path, monkeypatch)
    return harness.run_cell(bench(), cell, SEED, 0.3, False, "cpu",
                            time.perf_counter())


@pytest.mark.parametrize("cell", cells())
def test_the_sound_path_is_correct(tmp_path, monkeypatch, cell):
    r = _run(tmp_path, monkeypatch, cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("cell,fault", list(_cases()))
def test_a_planted_fault_is_not_correct(tmp_path, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    r = _run(tmp_path, monkeypatch, cell)
    limit = check.limits(cell)["widest_gap"]["limit"]
    assert r["checks"]["widest_gap"]["limit"] == limit
    assert not r["correct"], r["checks"]

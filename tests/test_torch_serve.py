"""``repro_torch.serve`` and ``repro_torch.launch.serve``: the serving engine
against the reference's, on the same weights (``convert``).

Greedy ``generate`` must give the reference's tokens exactly.  Before it
is held to that, each test checks that every greedy choice the port made
won by more than the logits' tolerance (2e-4 of the largest |logit|), so
that a tie cannot turn a rounding difference into another token.

The serving path's spans (``repro_torch.obs.trace``), on a smoke rwkv6
and a dense model: the same outputs traced and untraced, one
``serve.step`` a decode step with its children under it, the counts on
``serve.generate``, one ``serve.request`` a request with its stamps in
order, one ``ssm.rwkv_scan`` a layer a forward, and ``launch.serve
--trace PATH``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import get_config as jget  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch.serve import serve_demo  # noqa: E402
from repro_torch.models.registry import build_model as tbuild  # noqa: E402
from repro_torch.models.registry import get_config as tget  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)


def _pair(arch, seed, impl="xla"):
    cfg = jget(arch, smoke=True, dtype="float32", param_dtype="float32",
               attention_impl=impl)
    jm = jbuild(cfg)
    params = jm.init(jax.random.PRNGKey(seed))
    model = convert.model_params_from_numpy(
        jax.tree.map(np.asarray, params), cfg, device="cpu")
    return cfg, jm, params, model


class GapRecorder:
    """Wraps a model's ``decode_step`` to record, for the slots that were
    busy, the least gap between the top two logits relative to the
    largest |logit|."""

    def __init__(self, model):
        self.least = np.inf
        self._step = model.decode_step
        model.decode_step = self

    def __call__(self, cache, tokens):
        logits, cache = self._step(cache, tokens)
        last = logits[:, -1]
        top2 = torch.topk(last, 2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]) / last.abs().max()
        self.least = min(self.least, float(gap.min()))
        return logits, cache


def test_generate_greedy_matches_reference():
    """The inputs of the reference's continuous-batching test: 5 requests
    of 5 tokens through 2 slots, 4 new tokens each."""
    cfg, jm, params, model = _pair("qwen1.5-0.5b", 0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=5).astype(np.int32)
               for _ in range(5)]
    want = JServeEngine(jm, max_len=32, batch_size=2).generate(
        params, prompts, max_new_tokens=4)
    gaps = GapRecorder(model)
    got = ServeEngine(model, max_len=32, batch_size=2).generate(
        prompts, max_new_tokens=4)
    assert gaps.least > 2e-4
    assert len(got) == 5 and all(len(o) == 4 for o in got)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_generate_mixed_lengths_matches_reference(impl):
    """Prompts of 2-9 tokens through 3 slots on llama's grouped heads: slots
    are reused while others are mid-prompt."""
    cfg, jm, params, model = _pair("llama3.2-3b", 2, impl)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=rng.integers(2, 10))
               .astype(np.int32) for _ in range(7)]
    want = JServeEngine(jm, max_len=24, batch_size=3).generate(
        params, prompts, max_new_tokens=5)
    gaps = GapRecorder(model)
    got = ServeEngine(model, max_len=24, batch_size=3).generate(
        prompts, max_new_tokens=5)
    assert gaps.least > 2e-4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_slot_reuse_is_isolated():
    """A request served through a reused slot gives the same output as the
    same request served alone (per-slot position reset), and the
    reference's tokens."""
    cfg, jm, params, model = _pair("llama3.2-3b", 1)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=6).astype(np.int32)
               for _ in range(3)]
    outs_seq = ServeEngine(model, max_len=32, batch_size=1).generate(
        prompts, max_new_tokens=5)
    outs_alone = ServeEngine(model, max_len=32, batch_size=1).generate(
        [prompts[2]], max_new_tokens=5)
    np.testing.assert_array_equal(outs_seq[2], outs_alone[0])
    want = JServeEngine(jm, max_len=32, batch_size=1).generate(
        params, prompts, max_new_tokens=5)
    for a, b in zip(outs_seq, want):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_prefill_and_prefill_into_cache_match(impl):
    cfg, jm, params, model = _pair("qwen1.5-0.5b", 3, impl)
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jeng = JServeEngine(jm, max_len=16, batch_size=2)
    eng = ServeEngine(model, max_len=16, batch_size=2)
    np.testing.assert_allclose(
        eng.prefill({"tokens": torch.as_tensor(tokens)}).numpy(),
        np.asarray(jeng.prefill(params, {"tokens": jnp.asarray(tokens)})),
        **LOGIT_TOL)
    jl, jcache = jeng.prefill_into_cache(params, jnp.asarray(tokens))
    got, cache = eng.prefill_into_cache(tokens)
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               **LOGIT_TOL)
    np.testing.assert_array_equal(cache["pos"].numpy(), [12, 12])


def test_reset_slots_zeroes_only_the_chosen_positions():
    _, _, _, model = _pair("qwen1.5-0.5b", 0)
    eng = ServeEngine(model, max_len=8, batch_size=3)
    cache = model.init_cache(3, 8)
    cache["pos"] = torch.tensor([4, 5, 6], dtype=torch.int32)
    out = eng.reset_slots(cache, np.array([False, True, False]))
    assert out["pos"].tolist() == [4, 0, 6]
    assert cache["pos"].tolist() == [4, 5, 6]
    assert out["k"] is cache["k"]


def test_sampling_draws_from_the_given_generator():
    _, _, _, model = _pair("qwen1.5-0.5b", 5)
    eng = ServeEngine(model, max_len=32, batch_size=2)
    prompts = [np.array([1, 2, 3], np.int32), np.array([7, 8], np.int32),
               np.array([9], np.int32)]

    def run(seed):
        return eng.generate(prompts, max_new_tokens=6, greedy=False,
                            generator=torch.Generator().manual_seed(seed))

    a, b = run(11), run(11)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert all(len(x) == 6 and ((0 <= x) & (x < 256)).all() for x in a)


def test_serve_demo_on_cpu_at_its_defaults():
    out = serve_demo("qwen1.5-0.5b", smoke=True, device="cpu")
    assert out["requests"] == 12 and out["tokens"] == 12 * 16
    assert out["device"] == "cpu" and out["tok_per_s"] > 0
    assert len(out["outputs"]) == 3 and len(out["outputs"][0]) == 8


# ------------------------------------------------- the serving path's spans
def _served(arch, n=7, slots=3, max_new=4, traced=True):
    """``generate`` of ``n`` prompts of 2-5 tokens through ``slots`` slots
    on the smoke ``arch``: the outputs, the decode steps run, and the
    spans recorded (none untraced)."""
    cfg = tget(arch, smoke=True, dtype="float32", param_dtype="float32")
    model = tbuild(cfg, device="cpu", seed=0)
    eng = ServeEngine(model, max_len=24, batch_size=slots)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, size=rng.integers(2, 6))
               .astype(np.int32) for _ in range(n)]
    steps = [0]
    step = eng.serve_step

    def counted(cache, tokens):
        steps[0] += 1
        return step(cache, tokens)

    eng.serve_step = counted
    if traced:
        obs_trace.enable()
    try:
        outs = eng.generate(prompts, max_new_tokens=max_new)
    finally:
        obs_trace.disable()
    evs = obs_trace.events()
    obs_trace.clear()
    return prompts, outs, steps[0], evs


@pytest.fixture(scope="module", params=["rwkv6-3b", "qwen1.5-0.5b"])
def served(request):
    return request.param, _served(request.param)


def test_tracing_leaves_the_outputs_alone(served):
    arch, (_, outs, _, _) = served
    _, plain, _, evs = _served(arch, traced=False)
    assert evs == []
    assert len(outs) == len(plain)
    for a, b in zip(outs, plain):
        np.testing.assert_array_equal(a, b)


def test_one_step_span_a_decode_step(served):
    _, (_, _, n_steps, evs) = served
    steps = {e["id"] for e in evs if e["name"] == "serve.step"}
    assert len(steps) == n_steps
    for name in ("serve.feed", "serve.decode", "serve.token_read",
                 "serve.bookkeep"):
        kids = [e["parent"] for e in evs if e["name"] == name]
        assert sorted(kids) == sorted(steps), name
    resets = [e["parent"] for e in evs if e["name"] == "serve.reset_slots"]
    assert resets and set(resets) <= steps and len(set(resets)) == len(resets)
    call = [e for e in evs if e["name"] == "serve.generate"]
    assert len(call) == 1
    assert all(e["parent"] == call[0]["id"] for e in evs
               if e["name"] == "serve.step")


def test_generate_span_counts(served):
    _, (prompts, _, n_steps, evs) = served
    (call,) = [e for e in evs if e["name"] == "serve.generate"]
    n, slots = len(prompts), 3
    assert call["args"] == {"steps": n_steps, "token_reads": n_steps,
                            "slot_resets": n - slots, "requests": n}


def test_one_request_span_a_request(served):
    _, (prompts, outs, _, evs) = served
    (call,) = [e for e in evs if e["name"] == "serve.generate"]
    reqs = sorted((e for e in evs if e["name"] == "serve.request"),
                  key=lambda e: e["args"]["rid"])
    assert [e["args"]["rid"] for e in reqs] == list(range(len(prompts)))
    us = 1e3               # ts and dur are float us: 1 us of rounding
    start = call["ts"] * 1e3
    for e, prompt, out in zip(reqs, prompts, outs):
        a = e["args"]
        enq, end = e["ts"] * 1e3, (e["ts"] + e["dur"]) * 1e3
        assert start - us <= enq <= a["slot_ns"] + us, (a, enq)
        assert a["slot_ns"] <= a["first_token_ns"] <= end + us, (a, end)
        assert a["call"] == call["id"] and 0 <= a["slot"] < 3
        assert a["prompt_len"] == len(prompt) and a["new_tokens"] == len(out)
    # The first three took their slots at the call's start.
    assert all(e["args"]["slot_ns"] == reqs[0]["args"]["slot_ns"]
               for e in reqs[:3])
    assert reqs[3]["args"]["slot_ns"] > reqs[0]["args"]["slot_ns"]


def test_rwkv_scan_span_a_layer_a_forward():
    cfg = tget("rwkv6-3b", smoke=True, dtype="float32",
               param_dtype="float32")
    model = tbuild(cfg, device="cpu", seed=0)
    eng = ServeEngine(model, max_len=16, batch_size=2)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 9)))
    obs_trace.enable()
    try:
        for _ in range(2):
            eng.prefill({"tokens": tokens})
    finally:
        obs_trace.disable()
    evs = obs_trace.events()
    obs_trace.clear()
    prefills = [e["id"] for e in evs if e["name"] == "serve.prefill"]
    scans = [e["parent"] for e in evs if e["name"] == "ssm.rwkv_scan"]
    assert len(prefills) == 2
    assert len(scans) == 2 * cfg.n_layers
    assert sorted(scans) == sorted(prefills * cfg.n_layers)


def test_launch_serve_writes_its_spans(tmp_path, capsys):
    import json

    from repro_torch.launch import serve as launch_serve

    path = tmp_path / "spans.json"
    launch_serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                       "--slots", "2", "--trace", str(path)])
    assert not obs_trace.enabled()
    assert f"spans written to {path}" in capsys.readouterr().out
    evs = json.loads(path.read_text())["traceEvents"]
    names = [e["name"] for e in evs]
    assert names.count("serve.generate") == 1
    assert names.count("serve.request") == 3
    obs_trace.clear()

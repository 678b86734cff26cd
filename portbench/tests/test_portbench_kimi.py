"""The kimi-k2-instruct cell's own files: the ``prefill_spans`` entry, the
counts of ``counts/mla_moe.py``, the five readers and the reference's
parameter names, on the CPU at the smoke size that ``conftest.py`` adds
to ``_smoke``'s tables."""

import json
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import check, harness, trace, traffic
from portbench.counts import h100, mla_moe
from portbench.entries import prefill_spans
from portbench.reference import weights as weights_mod
from portbench.tests._smoke import CONFIGS, bench, use_smoke_sizes

CELL = "kimi-k2-instruct.prefill_long"
READERS = ("mfu.prefill_spans", "mla_flash_roofline.prefill_spans",
           "moe_experts_roofline.prefill_spans", "moe_overhead.prefill_spans",
           "device_idle.prefill_spans")
SMOKE_CONFIG = CONFIGS["kimi-k2-instruct"]


def _spec():
    """The cell's model at full size, from its configuration file."""
    return json.loads((harness.HERE / "configs" / "kimi-k2-instruct.json")
                      .read_text())["model"]


def _cfg():
    return dict(_spec(), **SMOKE_CONFIG)


def test_the_cells_entries_fit_the_benchmark():
    """The cell is listed with its configuration, mix, limit and five
    readers; the readers list only the cell and move ``prefill_tok_s``,
    which reports it."""
    b = bench()
    cell = harness.cell_of(b, CELL)
    assert cell["chips"] == 1 and cell["config"] == "kimi-k2-instruct"
    assert harness.config_of(b, "kimi-k2-instruct")["model"] == _spec()
    assert traffic.load(cell["traffic"])["entry"] == "prefill_spans"
    assert "widest_gap" in check.limits(CELL)
    ours = [m for m in b["per_layer"] if CELL in m.get("workloads", [CELL])]
    assert [m["name"] for m in ours] == list(READERS)
    for m in ours:
        assert m["workloads"] == [CELL] and m["moves"] == "prefill_tok_s"
        harness.reader(m["name"])
    rate, = [m for m in b["end_to_end"] if m["name"] == "prefill_tok_s"]
    assert CELL in rate["workloads"]


def test_the_reference_names_are_the_ports():
    cfg = _cfg()
    specs = weights_mod.family_module(cfg).param_specs(cfg)
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.transformer import Model

    model = Model(ModelConfig(**cfg), device="meta")
    got = {n: (tuple(p.shape), str(p.dtype).split(".")[1])
           for n, p in model.named_parameters()}
    assert got == {n: (tuple(s), dt) for n, (s, dt, _) in specs.items()}


@pytest.mark.parametrize("trace_on", [False, True])
def test_the_cell_runs_through_the_harness(tmp_path, monkeypatch, trace_on):
    """Untraced: ``prefill_tok_s`` and ``setup_s`` (no allocator to read
    on the CPU).  Traced: of the five readers only ``mfu.prefill_spans``
    reads a number on the CPU, where no kernel runs (their docstrings)."""
    use_smoke_sizes(tmp_path, monkeypatch)
    r = harness.run_cell(bench(), CELL, 2 ** 31 + 11, 0.3, trace_on,
                         "cpu", time.perf_counter())
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["compared_positions"] > 0
    assert r["correct"] and set(r["checks"]) == {"widest_gap"}
    want = {"mfu.prefill_spans"} if trace_on else {"prefill_tok_s",
                                                   "setup_s"}
    assert set(r["metrics"]) == want


def test_the_traced_cycle_counts_spans_calls_and_pairs(tmp_path, monkeypatch):
    """One ``mla.prefill`` a layer and one ``moe.*`` set an MoE layer a
    batch; the held pairs of each MoE call, at most T * min(k, E)."""
    use_smoke_sizes(tmp_path, monkeypatch)
    cfg = _cfg()
    mix = traffic.load("prefill_long")
    with torch.no_grad():
        model = harness.build(cfg, weights_mod.draw(cfg, 5, "cpu"))
        runner = prefill_spans.Runner(model, cfg, mix, 5, torch.device("cpu"))
        runner.warmup()
        info = runner.traced(trace.Window())
    n = len(mix["lengths"])
    moe_layers = cfg["n_layers"] - cfg["first_k_dense"]
    assert info["span_counts"] == {
        "mla.prefill": cfg["n_layers"] * n, "moe.route": moe_layers * n,
        "moe.dispatch": moe_layers * n, "moe.experts": moe_layers * n,
        "moe.combine": moe_layers * n}
    assert info["mla_prefill_calls"] == cfg["n_layers"] * n
    assert info["grouped_expert_calls"] == moe_layers * n
    assert len(info["held_pairs"]) == moe_layers * n
    tokens = [mix["batch"] * s for _, s in info["batches"]
              for _ in range(moe_layers)]
    k, e = cfg["n_experts_per_token"], cfg["n_experts"]
    # The batches' order is the cycle's; each call's count fits its batch.
    assert sorted(info["held_pairs"]) != [0] * len(tokens)
    for count, t in zip(info["held_pairs"], tokens):
        assert 0 <= count <= t * min(k, e)
    assert set(info["span_device_s"]) == set(prefill_spans.SPANS)
    assert all(v == 0.0 for v in info["span_device_s"].values())


def test_the_window_counts_by_mla_moe(tmp_path, monkeypatch):
    """The window is ``entries.prefill``'s, its FLOPs ``mla_moe``'s; the
    prefill entry counts by ``model_step`` again after it."""
    from portbench.counts import model_step
    from portbench.entries import prefill

    use_smoke_sizes(tmp_path, monkeypatch)
    cfg = _cfg()
    mix = traffic.load("prefill_long")
    with torch.no_grad():
        model = harness.build(cfg, weights_mod.draw(cfg, 6, "cpu"))
        runner = prefill_spans.Runner(model, cfg, mix, 6, torch.device("cpu"))
        w = runner.window(0.0)
    assert prefill.model_step is model_step
    assert w["batches"] and w["model_flops"] == float(sum(
        mla_moe.prefill_flops(cfg, b, s) for b, s in w["batches"]))


def test_the_counts_by_hand():
    cfg = dict(family="moe", n_layers=3, first_k_dense=1, d_model=8,
               n_heads=2, q_lora_rank=4, kv_lora_rank=2, qk_nope_head_dim=3,
               qk_rope_head_dim=2, v_head_dim=3, d_ff=16, moe_d_ff=5,
               n_experts=2, router_experts=8, n_experts_per_token=4,
               n_shared_experts=1, vocab_size=10)
    mla = 8 * 4 + 4 * 2 * 5 + 8 * 4 + 2 * 2 * 6 + 2 * 3 * 8
    experts = 8 * 8 + 3 * 8 * 5 + 4 * 2 / 8 * 3 * 8 * 5
    per_token = 3 * mla + 3 * 8 * 16 + 2 * experts + 8 * 10
    att = 2 * (3 + 2 + 3) * 2 * (6 * 7 // 2)
    assert mla_moe.prefill_flops(cfg, 1, 6) == 6 * 2 * per_token + 3 * att
    assert mla_moe.attention_bytes(cfg, 1, 6, 2) == 6 * 2 * (2 * 5 + 2 * 3) * 2
    assert mla_moe.experts_least_seconds(cfg, 10, 2) == max(
        2 * 10 * 3 * 8 * 5 / h100.PEAK_BF16_FLOPS,
        (2 * 3 * 8 * 5 + 2 * 10 * 8) * 2 / h100.HBM_BW)


def test_the_full_size_counts():
    spec = _spec()
    per_token = mla_moe.products_per_token(spec)
    assert mla_moe.mla_weights(spec) == 101_122_048
    assert 4.84e9 < per_token < 4.86e9
    # 640 FLOPs a head a causal pair: q.k over 192, p.v over 128.
    assert mla_moe.attention_flops(spec, 1, 2) == 640 * 64 * 3
    cycle = sum(mla_moe.prefill_flops(spec, 1, s)
                for s in (8192, 16384, 32768))
    assert 1.15e15 < cycle < 1.17e15


def _run(trace_info, entry="prefill_spans"):
    cfg = _spec()
    return {"cfg": cfg, "mix": {"entry": entry}, "trace": trace_info,
            "window": {"seconds": 50.0, "model_flops": 1.0e16}}


def test_the_readers_by_hand():
    cfg = _spec()
    batches = [[1, 8192], [1, 32768]]
    t = {"busy_s": 4.0, "window_s": 5.0, "batches": batches,
         "by_name": {"void flash_attention_kernel<bf16, 256>": [42, 2.0],
                     "gemm": [100, 1.0]},
         "span_device_s": {"moe.route": 0.1, "moe.dispatch": 0.2,
                           "moe.experts": 0.5, "moe.combine": 0.1},
         "held_pairs": [2048] * 20 + [8192] * 20}
    read = {m: harness.reader(m) for m in READERS}
    run = _run(t)
    assert read["mfu.prefill_spans"](run) == pytest.approx(
        100 * 1.0e16 / (50.0 * h100.PEAK_BF16_FLOPS))
    least = 21 * sum(mla_moe.attention_least_seconds(cfg, b, s, 2)
                     for b, s in batches)
    assert read["mla_flash_roofline.prefill_spans"](run) == pytest.approx(
        100 * least / 2.0)
    least = sum(mla_moe.experts_least_seconds(cfg, n, 2)
                for n in t["held_pairs"])
    assert read["moe_experts_roofline.prefill_spans"](run) == pytest.approx(
        100 * least / 0.5)
    assert read["moe_overhead.prefill_spans"](run) == pytest.approx(10.0)
    assert read["device_idle.prefill_spans"](run) == pytest.approx(20.0)
    # Nothing without the kernel once a layer a batch, without the spans
    # and counts (a program that lacks them), or for another entry.
    short = dict(t, by_name={"void flash_attention_kernel": [41, 2.0]})
    assert read["mla_flash_roofline.prefill_spans"](_run(short)) is None
    bare = {k: v for k, v in t.items()
            if k not in ("span_device_s", "held_pairs")}
    assert read["moe_experts_roofline.prefill_spans"](_run(bare)) is None
    assert read["moe_overhead.prefill_spans"](_run(bare)) is None
    for m in READERS:
        assert read[m](_run(t, entry="prefill")) is None


class _Ev:
    def __init__(self, cuda, corr, start, end, name="k", annotation=False):
        from torch.autograd import DeviceType

        self._t = DeviceType.CUDA if cuda else DeviceType.CPU
        self._c, self._s, self._e, self._n = corr, start, end, name
        self._a = annotation

    def device_type(self):
        return self._t

    def correlation_id(self):
        return self._c

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def name(self):
        return self._n

    def is_user_annotation(self):
        return self._a


def test_span_device_seconds_follows_the_launches():
    """A kernel counts under the span in which its launch (the runtime
    call of the same correlation id) lies, wherever it ran."""
    events = [
        _Ev(False, 1, 1_500, 1_600, "cudaLaunchKernel"),
        _Ev(True, 1, 9_000, 10_000),                       # 1 us, late
        _Ev(False, 2, 2_500, 2_600, "cuLaunchKernelEx"),
        _Ev(True, 2, 10_000, 13_000),                      # 3 us
        _Ev(False, 3, 4_000, 4_100, "cudaLaunchKernel"),   # no span
        _Ev(True, 3, 13_000, 14_000),
        _Ev(True, 0, 9_000, 14_000, "moe.route", annotation=True),
        _Ev(False, 9, 1_000, 3_000, "aten::mm"),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    spans = [{"name": "moe.route", "ph": "X", "ts": 1.0, "dur": 1.0},
             {"name": "moe.experts", "ph": "X", "ts": 2.0, "dur": 1.0},
             {"name": "serve.prefill", "ph": "X", "ts": 0.0, "dur": 10.0}]
    got = prefill_spans.span_device_seconds(prof, spans,
                                            ("moe.route", "moe.experts",
                                             "moe.combine"))
    assert got == {"moe.route": 1e-6, "moe.experts": 3e-6, "moe.combine": 0.0}

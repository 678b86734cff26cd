"""Smoke sizes of the benchmark's configurations and mixes, for the CPU
tests: every width cut, the families and code paths kept."""

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

CONFIGS = {
    "starcoder2-3b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab_size=256, sliding_window=16),
    "rwkv6-3b": dict(n_layers=2, d_model=64, d_ff=224, vocab_size=256,
                     ssm_heads=4),
}
MIXES = {
    "prefill": dict(lengths=[24, 32, 40]),
    "generate": dict(slots=4, max_len=40, requests_per_call=16,
                     prompt_min=3, prompt_max=8, max_new_tokens=12, check=16),
}


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cells():
    return [c["name"] for c in bench()["workloads"]]


def use_smoke_sizes(tmp_path, monkeypatch):
    """Point the harness at a copy of ``BENCHMARK.json`` whose
    configuration and traffic files are cut to the smoke sizes; the
    limits, entries and readers stay the benchmark's own."""
    from portbench import harness, traffic

    b = bench()
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for c in b["configs"]:
        spec = json.loads((ROOT / c["file"]).read_text())
        spec["model"].update(CONFIGS[c["name"]])
        out = tmp_path / c["file"]
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(spec))
    mixes = tmp_path / "portbench" / "traffic"
    mixes.mkdir(parents=True, exist_ok=True)
    for name in {c["traffic"] for c in b["workloads"]}:
        mix = traffic.load(name)
        mix.update(MIXES[mix["entry"]])
        (mixes / f"{name}.json").write_text(json.dumps(mix))
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    monkeypatch.setattr(traffic, "HERE", tmp_path / "portbench")

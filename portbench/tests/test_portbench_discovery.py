"""A configuration, a traffic mix, a metric and a cell added as new files
and entries are found and run, with no file of the harness edited."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

from portbench.tests._smoke import CONFIGS

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
from portbench import harness
bench = harness.benchmark()
for trace in (0, 1):
    r = harness.run_cell(bench, "tiny-dense.prefill_tiny", 5, 0.2,
                         bool(trace), "cpu", time.perf_counter())
    print(json.dumps(r))
"""


def test_new_files_make_a_new_cell(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    pb = tmp_path / "portbench"

    spec = json.loads((pb / "configs" / "starcoder2-3b.json").read_text())
    spec["name"] = spec["model"]["name"] = "tiny-dense"
    spec["model"].update(CONFIGS["starcoder2-3b"])
    (pb / "configs" / "tiny-dense.json").write_text(json.dumps(spec))
    (pb / "traffic" / "prefill_tiny.json").write_text(json.dumps(
        {"entry": "prefill", "batch": 1, "lengths": [8, 12], "check": 1}))
    (pb / "metrics" / "prefill_batches.py").write_text(
        "def read(run):\n    return len(run['window']['batches'])\n")
    (pb / "limits" / "tiny-dense.prefill_tiny.json").write_text(
        json.dumps({"widest_gap": {"limit": 0.05}}))

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-dense", "source": "test",
                             "file": "portbench/configs/tiny-dense.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-dense.prefill_tiny",
                               "config": "tiny-dense",
                               "traffic": "prefill_tiny", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "prefill_tok_s":
            m["workloads"].append("tiny-dense.prefill_tiny")
    bench["per_layer"].append({
        "name": "prefill_batches", "unit": "batches", "better": "higher",
        "source": "program_counter", "layer": "serve engine",
        "moves": "prefill_tok_s", "workloads": ["tiny-dense.prefill_tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    proc = subprocess.run(
        [sys.executable, "-c",
         SCRIPT.format(root=str(tmp_path), src=str(ROOT / "src"))],
        capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    plain, traced = (json.loads(line) for line in
                     proc.stdout.strip().splitlines()[-2:])
    assert plain["correct"] and traced["correct"]
    # No peak_mem_gib: the CPU has no device allocator to read.
    assert set(plain["metrics"]) == {"prefill_tok_s", "setup_s"}
    assert set(traced["metrics"]) == {"prefill_batches"}
    assert traced["metrics"]["prefill_batches"]["value"] >= 2
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data, rel

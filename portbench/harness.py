"""The benchmark's run: one cell, one seed, one window.

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration file (``configs/<config>.json``, whose ``model`` object is
the port's ``ModelConfig``), its traffic mix (``traffic/<traffic>.json``,
whose ``entry`` names the runner ``entries/<entry>.py``), its limits
(``limits/<cell>.json``) and each metric's reader
(``metrics/<metric>.py``, ``read(run) -> number or None``).  Adding a
cell, a configuration, a mix or a metric adds files and entries; nothing
here changes.

A run: the weights drawn from the seed on the card and loaded into the
port's ``Model`` (built on ``meta``, so nothing else is drawn); the
runner's warm-up of every shape the cell uses; ``setup_s`` from process
start to here; the window; with ``--trace 1`` a profiled stretch after
it; the port's state dropped; then the reference over the runner's
sample, from weights drawn anew from the seed, and the verdict.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from portbench import check, trace, traffic
from portbench.reference import weights as weights_mod

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level module names that must not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_of(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: str, trace_on: bool):
    """The cell's metrics: end-to-end without trace, per-layer with."""
    group = bench["per_layer" if trace_on else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def load_weights(model, weights) -> None:
    """Put the drawn tensors into ``model`` under the port's names; the
    names, shapes and dtypes must match the port's exactly."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError("parameters differ from the reference's: "
                         f"{sorted(set(params) ^ set(weights))[:8]}")
    for name, p in params.items():
        w = weights[name]
        if p.shape != w.shape or p.dtype != w.dtype:
            raise ValueError(f"{name}: port {tuple(p.shape)} {p.dtype}, "
                             f"drawn {tuple(w.shape)} {w.dtype}")
        owner, leaf = name.rsplit(".", 1)
        setattr(model.get_submodule(owner), leaf,
                torch.nn.Parameter(w, requires_grad=False))


def build(cfg: dict, weights):
    """The port's model of ``cfg`` holding ``weights``."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.transformer import Model

    model = Model(ModelConfig(**cfg), device="meta")
    load_weights(model, weights)
    return model


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             trace_on: bool, device, t_start: float) -> dict:
    """One run; returns the result object."""
    device = torch.device(device)
    cell = cell_of(bench, cell_name)
    cfg = config_of(bench, cell["config"])["model"]
    mix = traffic.load(cell["traffic"])
    entry = importlib.import_module(f"portbench.entries.{mix['entry']}")
    cuda = device.type == "cuda"

    with torch.no_grad():
        model = build(cfg, weights_mod.draw(cfg, seed, device))
        runner = entry.Runner(model, cfg, mix, seed, device)
        runner.warmup()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    window = runner.window(seconds)
    window["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules()
    traced = None
    if trace_on:
        win = trace.Window()
        info = runner.traced(win)
        traced = dict(trace.summarise(win), **info)
    samples = runner.samples(int(mix["check"]))
    del runner, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    weights = weights_mod.draw(cfg, seed, device)
    gap, _, positions = check.widest_gaps(cfg, weights, samples, device)
    del weights
    lim = check.limits(cell_name)
    checks = {}
    if "widest_gap" in lim:
        checks["widest_gap"] = {"value": gap,
                                "limit": lim["widest_gap"]["limit"]}
    correct = (bool(checks) and window["failed"] == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))

    run = {"cell": cell_name, "cfg": cfg, "mix": mix, "setup_s": setup_s,
           "window": window, "trace": traced}
    metrics = {}
    for m in metrics_of(bench, cell_name, trace_on):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": int(max(setup_peak, window["peak_bytes"]))}
    if traced is not None:
        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = traced["window_s"]
    result = {"correct": correct, "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics,
              "device": dev}
    if traced is not None:
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["seed"] = seed
    result["compared_positions"] = positions
    result["forbidden_modules"] = found
    result["checks"] = checks
    return result


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = benchmark()
    cell = cell_of(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": no result", file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t_start)
    result["device"]["power_limit"] = power_limit()
    found = sorted(set(result.pop("forbidden_modules")) |
                   set(forbidden_modules()))
    if found:
        print(f"portbench: forbidden modules loaded: {found}: no result",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    if not result["checks"]:
        print("check: no limits for this cell", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0

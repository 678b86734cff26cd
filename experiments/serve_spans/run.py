"""The serving path's own spans (``repro_torch.obs.trace``) on the card,
in the benchmark's two rwkv6-3b cells (``portbench/``: the cells' own
configuration, traffic mix, drawn weights and runners).

For each cell, on one model:

* the cost of tracing: the cell's window (``Runner.window``) with the
  program's tracing off and on, each seed's two windows on the same
  prompts, in the order off/on, on/off, off/on;
* the traced stretch the benchmark profiles (``Runner.traced``) with
  tracing on: the device's idle time split by the host's innermost span
  (``obs_trace.idle_by_span``, against the profiler's busy union), and
  the readings that split gives (``idle_in_engine``, ``idle_in_decode``,
  ``idle_in_scan``) beside ``device_idle``; from the traced windows,
  ``host_step_ms`` (median of ``serve.step`` less its
  ``serve.token_read``) and ``ttft_p95_ms`` (``serve.request``);
* the clocks: each span against the profiler's ``record_function`` of
  the same name (start and end offsets), and where the stretch's kernel
  launches (``cudaLaunchKernel`` and kin) fall: every launch inside a
  ``serve.decode`` range must lie inside its span.

Needs an NVIDIA GPU (about 11 minutes on an H100):

    python3 experiments/serve_spans/run.py [--seconds 40] [--seeds 3] \
        [--json out.json]

prints ``[spans]`` lines, and with ``--json`` writes every reading there.
"""

from __future__ import annotations

import argparse
import bisect
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import harness, traffic  # noqa: E402
from portbench import trace as pb_trace  # noqa: E402
from portbench.reference import weights as weights_mod  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402

CELLS = ("rwkv6-3b.generate_batch", "rwkv6-3b.prefill_docs")
#: The spans of the engine's own host loop in a decode step.
ENGINE = ("serve.step", "serve.feed", "serve.token_read", "serve.bookkeep",
          "serve.reset_slots")
SEEDS = (3141592653, 2718281828, 1618033988)


def _line(msg: str) -> None:
    print(f"[spans] {msg}", flush=True)


# ------------------------------------------------------------- readings
def host_step_ms(spans):
    """Median over the decode steps of ``serve.step`` less its
    ``serve.token_read`` child, in ms."""
    steps = {e["id"]: e["dur"] for e in spans if e["name"] == "serve.step"}
    for e in spans:
        if e["name"] == "serve.token_read" and e["parent"] in steps:
            steps[e["parent"]] -= e["dur"]
    return float(np.median(list(steps.values()))) / 1e3 if steps else None


def ttft_p95_ms(spans):
    """95th percentile over the requests of the first token's read less
    the request's start (its call's start), in ms."""
    ttft = [(e["args"]["first_token_ns"] - e["ts"] * 1e3) / 1e6
            for e in spans if e["name"] == "serve.request"]
    return float(np.percentile(ttft, 95)) if ttft else None


def idle_share(idle, window_s, names):
    """Percent of the window the device idled under ``names``; nothing
    unless the first of them was recorded."""
    if names[0] not in idle:
        return None
    return 100.0 * sum(idle.get(n, 0.0) for n in names) / window_s


# --------------------------------------------------------- the profile
class Window(pb_trace.Window):
    """portbench's profiled window, its ends on the trace's clock."""

    def start(self):
        super().start()
        self.t0_ns = obs_trace.now_ns()

    def stop(self):
        super().stop()
        self.t1_ns = self.t0_ns + round(self.seconds * 1e9)


def _profile_rows(win):
    """(busy intervals, host events) of the profile, device work
    filtered as ``portbench/trace.py`` does."""
    from torch.autograd import DeviceType

    dev, cpu = [], []
    for e in win.prof.profiler.kineto_results.events():
        row = (e.start_ns(), e.end_ns(), e.name())
        if e.device_type() != DeviceType.CUDA:
            cpu.append(row)
        elif not (e.is_user_annotation() or row[2].startswith("portbench.")
                  or "Sync" in row[2]):
            dev.append(row)
    return pb_trace._merge([(s, e) for s, e, _ in dev]), cpu


def _is_launch(name: str) -> bool:
    return "LaunchKernel" in name or name.startswith("cuLaunch")


def clock_check(spans, cpu, t0, t1):
    """Each span wholly inside [t0, t1] against the ``record_function`` of
    its name that starts nearest it: the largest start and end offsets
    (range less span, span less range; both >= 0 when the span encloses
    its range), and the launches inside each ``serve.decode`` range that
    fall outside its span.  Also the stretch's launches by the span they
    fall in."""
    ranges = {}
    for s, e, name in cpu:
        ranges.setdefault(name, []).append((s, e))
    launches = sorted(s for s, _, n in cpu if _is_launch(n))
    worst = {}
    outside = in_decode = 0
    for ev in spans:
        s = ev["ts"] * 1e3
        e = s + ev["dur"] * 1e3
        if ev["name"] not in ranges or s < t0 or e > t1:
            continue
        rs, re_ = min(ranges[ev["name"]], key=lambda r: abs(r[0] - s))
        w = worst.setdefault(ev["name"],
                             [np.inf, -np.inf, np.inf, -np.inf, 0])
        w[0], w[1] = min(w[0], rs - s), max(w[1], rs - s)
        w[2], w[3] = min(w[2], e - re_), max(w[3], e - re_)
        w[4] += 1
        if ev["name"] == "serve.decode":
            lo = bisect.bisect_left(launches, rs)
            hi = bisect.bisect_right(launches, re_)
            in_decode += hi - lo
            outside += sum(not (s <= x <= e) for x in launches[lo:hi])
    by_span = {}
    for name, s, e in ((ev["name"], ev["ts"] * 1e3,
                        (ev["ts"] + ev["dur"]) * 1e3) for ev in spans):
        if name.startswith("serve.") and name != "serve.request":
            n = (bisect.bisect_right(launches, e)
                 - bisect.bisect_left(launches, s))
            by_span[name] = by_span.get(name, 0) + n
    return {
        "offsets_ns": {k: {"start_min": v[0], "start_max": v[1],
                           "end_min": v[2], "end_max": v[3], "spans": v[4]}
                       for k, v in worst.items()},
        "largest_offset_us": max((max(abs(x) for x in v[:4])
                                  for v in worst.values()), default=0.0) / 1e3,
        "decode_launches": in_decode,
        "decode_launches_outside_span": outside,
        "launches": len(launches),
        "launches_by_span": by_span,
    }


# ------------------------------------------------------------ the cells
def run_cell(bench, cell_name: str, seeds, seconds: float, device):
    cell = harness.cell_of(bench, cell_name)
    cfg = harness.config_of(bench, cell["config"])["model"]
    mix = traffic.load(cell["traffic"])
    entry = importlib.import_module(f"portbench.entries.{mix['entry']}")
    out_key = ("generated_tokens" if mix["entry"] == "generate"
               else "prefill_tokens")
    with torch.no_grad():
        model = harness.build(cfg, weights_mod.draw(cfg, seeds[0], device))
    rates = {"off": [], "on": []}
    spans_on = []
    runner = None
    for i, seed in enumerate(seeds):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            runner = entry.Runner(model, cfg, mix, seed, device)
            runner.warmup()
            torch.cuda.synchronize()
            if on:
                obs_trace.enable()
            w = runner.window(seconds)
            obs_trace.disable()
            if on:
                spans_on += obs_trace.events()
            obs_trace.clear()
            rate = w[out_key] / w["seconds"]
            rates["on" if on else "off"].append(rate)
            _line(f"{cell_name} seed {seed} tracing {'on ' if on else 'off'}"
                  f" {rate!r} tokens/s over {w['seconds']!r} s")
    pairs = [b / a - 1.0 for a, b in zip(rates["off"], rates["on"])]
    _line(f"{cell_name} tracing on against off, by seed: "
          f"{[round(100 * p, 4) for p in pairs]} % (medians off "
          f"{float(np.median(rates['off']))!r}, on "
          f"{float(np.median(rates['on']))!r} tokens/s)")

    win = Window()
    obs_trace.enable()
    info = runner.traced(win)
    obs_trace.disable()
    spans = obs_trace.events()
    obs_trace.clear()
    busy, cpu = _profile_rows(win)
    busy_s = sum(e - s for s, e in busy) / 1e9
    idle = obs_trace.idle_by_span(spans, busy, win.t0_ns, win.t1_ns)
    window_s = win.seconds
    readings = {
        "device_idle": 100.0 * (1.0 - busy_s / window_s),
        "idle_in_engine": idle_share(idle, window_s, ENGINE),
        "idle_in_decode": idle_share(idle, window_s, ("serve.decode",)),
        "idle_in_scan": idle_share(idle, window_s, ("ssm.rwkv_scan",)),
        "host_step_ms": host_step_ms(spans_on),
        "ttft_p95_ms": ttft_p95_ms(spans_on),
    }
    split = sum(idle.values())
    off_by = 100 * abs(split - (window_s - busy_s)) / window_s
    check = clock_check(spans, cpu, win.t0_ns, win.t1_ns)
    _line(f"{cell_name} traced stretch {info}: window {window_s!r} s, busy "
          f"{busy_s!r} s, idle {window_s - busy_s!r} s, split "
          f"{split!r} s (off by {off_by!r} % of the window)")
    _line(f"{cell_name} idle by span (s): "
          + json.dumps({k: round(v, 6) for k, v in
                        sorted(idle.items(), key=lambda kv: -kv[1])}))
    _line(f"{cell_name} readings: " + json.dumps(readings))
    _line(f"{cell_name} clocks: largest span-range offset "
          f"{check['largest_offset_us']!r} us; decode launches "
          f"{check['decode_launches']}, outside their span "
          f"{check['decode_launches_outside_span']}; launches by span "
          + json.dumps(check["launches_by_span"]))
    del runner, model
    torch.cuda.empty_cache()
    return {"rates": rates, "on_vs_off": pairs, "traced": info,
            "window_s": window_s, "busy_s": busy_s, "idle_by_span": idle,
            "split_s": split, "readings": readings, "clocks": check}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seeds", type=int, default=len(SEEDS))
    ap.add_argument("--cells", nargs="*", default=list(CELLS))
    ap.add_argument("--json", default=None, metavar="PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU with CUDA", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    _line(f"card {card.strip()}; torch {torch.__version__}")
    bench = harness.benchmark()
    device = torch.device("cuda")
    out = {"card": card.strip(), "cells": {}}
    t0 = time.perf_counter()
    for cell in args.cells:
        out["cells"][cell] = run_cell(bench, cell, SEEDS[:args.seeds],
                                      args.seconds, device)
    _line(f"done in {time.perf_counter() - t0:.1f} s")
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings that the limits of ``correct`` are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 ...

For each seed, in one process (the model's set-up is paid once): the
weights drawn from the seed and loaded into the port, the cell's runner
at its own sizes for one stretch of its load (a prefill cycle, which
holds the longest length; one ``generate`` call), the same sample that a
run compares, and two readings on it: the port's widest gap (the lower
end of a limit) and the float8 control's (the upper end).  One JSON line
a seed, then a summary line.  Not part of a benchmark run.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from portbench import check, harness, traffic  # noqa: E402
from portbench.reference import weights as weights_mod  # noqa: E402


def readings(bench, cell_name: str, seeds, device):
    """Yields one dict a seed: the port's widest gap and the control's."""
    cell = harness.cell_of(bench, cell_name)
    cfg = harness.config_of(bench, cell["config"])["model"]
    mix = traffic.load(cell["traffic"])
    entry = importlib.import_module(f"portbench.entries.{mix['entry']}")
    model = None
    for n, seed in enumerate(seeds):
        t0 = time.perf_counter()
        with torch.no_grad():
            w = weights_mod.draw(cfg, seed, device)
            if model is None:
                model = harness.build(cfg, w)
            else:
                harness.load_weights(model, w)
            del w
            runner = entry.Runner(model, cfg, mix, seed, device)
            if n == 0:
                runner.warmup()
            runner.window(0.0)
        samples = runner.samples(int(mix["check"]))
        del runner
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref_w = weights_mod.draw(cfg, seed, device)
        prog, ctrl, positions = check.widest_gaps(cfg, ref_w, samples,
                                                  device, control=True)
        del ref_w
        yield {"workload": cell_name, "seed": seed, "program": prog,
               "control": ctrl, "positions": positions,
               "seconds": time.perf_counter() - t0}


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    progs, ctrls = [], []
    for r in readings(harness.benchmark(), args.workload, args.seeds,
                      torch.device("cuda")):
        progs.append(r["program"])
        ctrls.append(r["control"])
        print(json.dumps(r), flush=True)
    print(json.dumps({"workload": args.workload, "summary": True,
                      "lower": max(progs), "upper": min(ctrls),
                      "program": progs, "control": ctrls,
                      "device": torch.cuda.get_device_name(0),
                      "power_limit": harness.power_limit()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""The dry-run's full sweep, then co-location of its jobs on the card.

Every cell of ``repro_torch.launch.dryrun.all_cells`` on both production
meshes (32 on 16x16 and 32 on 2x16x16: all ten archs at full size on
``meta``, kimi-k2 at its 61 layers, ``long_500k`` for hymba and rwkv6
only), the cells traced ``--jobs`` at a time in spawned processes, the
longest first; then ``core.colocation.plan_colocation`` of the 64 records
with a fitted ``SYNPA4_R-FEBE`` on the card against the CPU (pairs
identical, ``predicted_cost`` within 1e-5 relative), beside a seeded
random pairing's true mean slowdown.  From the root of a checkout, on a
machine with an NVIDIA GPU::

    python3 experiments/dryrun_sweep/run.py [--jobs 8] [--out DIR]

Prints the card's name and power limit, one line a cell (status, wall,
terms) and the plans; with ``--out`` also writes the records to
``DIR/records.json``.  The cells' walls are the host's: the dry-run
touches no card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))

def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import colocation, isc
    from repro_torch.kernels.pair_score import kernel as ps_kernel
    from repro_torch.launch import dryrun
    from repro_torch.smt import training
    from repro_torch.smt.machine import MachineParams, SMTMachine

    if not torch.cuda.is_available():
        print("dryrun_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)

    cells = [c + (mp,) for mp in (False, True) for c in dryrun.all_cells(mp)]
    cells.sort(key=lambda c: c[:2] not in dryrun.LOOP_BOUND)   # longest first
    t0 = time.perf_counter()
    results = dryrun.run_cells(cells, jobs=args.jobs)
    sweep_s = time.perf_counter() - t0
    records, bad = [], 0
    for (arch, shape, status, rec, wall), cell in zip(results, cells):
        mesh = "2x16x16" if cell[2] else "16x16"
        if status != "ok":
            bad += 1
            print(f"{status.upper()} {arch} x {shape} on {mesh}: {rec}",
                  flush=True)
            continue
        records.append(rec)
        counts = {k: v for k, v in rec["collective_counts"].items() if v}
        print(f"OK {arch} x {shape} on {mesh}: wall {wall:.1f} s; compute "
              f"{rec['compute_s']:.6f} s, memory {rec['memory_s']:.6f} s, "
              f"collective {rec['collective_s']:.6f} s -> {rec['dominant']};"
              f" useful {rec['useful_flops_ratio']:.4f}, roofline "
              f"{rec['roofline_fraction']:.4f}, "
              f"{rec['bytes_per_device'] / 2**30:.2f} GiB/dev, fits "
              f"{rec['fits_hbm']}; {counts}", flush=True)
    print(f"sweep: {len(records)} records, {bad} not ok, {sweep_s:.1f} s on "
          f"{args.jobs} processes; process group left: "
          f"{dist.is_initialized()}", flush=True)
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "records.json").write_text(json.dumps(records, indent=1))

    models, _ = training.build_all_models(
        SMTMachine(MachineParams(), seed=0),
        methods={"SYNPA4_R-FEBE": isc.SYNPA4_R_FEBE}, device="cuda")
    model = models["SYNPA4_R-FEBE"]
    jobs = records[:len(records) // 2 * 2]
    cpu = colocation.plan_colocation(jobs, model, device="cpu")
    ps_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    card = colocation.plan_colocation(jobs, model, device="cuda")
    torch.cuda.synchronize()
    plan_ms = (time.perf_counter() - t0) * 1e3
    rel = abs(card.predicted_cost - cpu.predicted_cost) / abs(
        cpu.predicted_cost)
    perm = np.random.default_rng(40).permutation(len(jobs))
    rand = [tuple(sorted(p)) for p in perm.reshape(-1, 2).tolist()]
    same_names = (sorted(tuple(sorted(p)) for p in card.named_pairs())
                  == sorted(tuple(sorted(p)) for p in cpu.named_pairs()))
    print(f"colocation: {len(jobs)} jobs onto {len(card.pairs)} slices, "
          f"pair_score launches {ps_kernel.LAUNCHES}, plan wall "
          f"{plan_ms:.3f} ms (first call); pairs identical on the card and "
          f"the CPU: {card.pairs == cpu.pairs}, by job name (a cell's two "
          f"meshes can tie): {same_names}; predicted cost card "
          f"{card.predicted_cost!r} CPU {cpu.predicted_cost!r} (rel "
          f"{rel:.2e}); true mean slowdown SYNPA "
          f"{colocation.evaluate_placement(jobs, card.pairs)!r}, seeded "
          f"random {colocation.evaluate_placement(jobs, rand)!r}", flush=True)
    for a, b in card.named_pairs():
        print(f"  {a} <-> {b}")
    ok = (bad == 0 and same_names and rel <= 1e-5
          and not dist.is_initialized())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

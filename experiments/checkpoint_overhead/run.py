"""Where the checkpointed open run's extra time goes: the open main path's
faulted fifo run (``chip_smoke.py`` phase 13: capacity 1024, rho 1.0, 24
quanta, seed 11, the ``combined`` faults, fitted ``SYNPA4_R-FEBE``) timed
five ways, in turns on one card:

* ``warm``      — ``run_device_sim`` after a warm run of its own inputs
  (``sim.run(q, repeats=1)``: the timed run), as phase 13 times it;
* ``cold``      — ``run_device_sim`` on freshly committed inputs, no warm
  run (``sim.run(q, warmup=False)``), as a checkpointed call runs;
* ``segments``  — the same horizon as three segments of 8 quanta
  (``_build_race(segment=True)``), no copy, no snapshot;
* ``copies``    — the segments, each ending in the snapshot's one
  device-to-host copy (``_fetch_host``), no snapshot written;
* ``ckpt``      — ``run_device_sim_checkpointed`` (a fresh directory a
  call).

Each is the wall per quantum of its loop (inputs committed before the
clock starts, ``torch.cuda.synchronize()`` at both ends).  Rounds run
forward and back three times.  Needs an NVIDIA GPU and ``nvcc``; from the
root of a checkout::

    python3 experiments/checkpoint_overhead/run.py

Prints the card's name and power limit, every round and each way's
median and spread (max - min).
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

WAYS = ("warm", "cold", "segments", "copies", "ckpt")
SEG = 8


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("checkpoint_overhead: no CUDA device is available",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import isc
    from repro_torch.online import (ClusterSim, FaultProfile,
                                    PoissonArrivals,
                                    run_device_sim_checkpointed)
    from repro_torch.online import device_sim
    from repro_torch.smt import training
    from repro_torch.smt.apps import pool_profiles
    from repro_torch.smt.machine import MachineParams, PhaseTables, SMTMachine
    from repro_torch.smt.scan_engine import LaneDraws, ScanPolicy, TorchDraws

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    model = training.build_all_models(
        SMTMachine(MachineParams(), seed=0),
        methods={"SYNPA4_R-FEBE": isc.SYNPA4_R_FEBE},
        device=dev)[0]["SYNPA4_R-FEBE"]
    machine = SMTMachine(MachineParams(), seed=0)
    pool = pool_profiles()
    n_cores = cs.OPEN_CAPACITY // 2
    q = cs.OPEN_QUANTA
    sim = ClusterSim(
        machine, pool, n_cores,
        ScanPolicy(kind="synpa", method=isc.SYNPA4_R_FEBE, model=model,
                   name="synpa4"),
        PoissonArrivals(rate=cs.OPEN_RHO * cs.OPEN_CAPACITY
                        / cs.mean_service_quanta(machine),
                        n_pool=len(pool)),
        seed=cs.OPEN_SEED, target_scale=cs.TARGET_SCALE,
        tables=PhaseTables.build(pool), engine="scan", device=dev,
        faults=cs._fault_profile(FaultProfile, "combined", n_cores, q))
    tmp = tempfile.TemporaryDirectory(prefix="checkpoint_overhead_")

    def segmented(copy: bool) -> float:
        prep = device_sim._prepare_inputs(sim, q)
        run = device_sim._grid_race(
            [sim], [prep], SEG, prep["j_pad"],
            (prep["syn_cost"], prep["syn_mean"], prep["syn_stacks"]),
            LaneDraws([TorchDraws(sim.seed, dev)]), segment=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = None
        for q0 in range(0, q, SEG):
            state, cols = run(state, q0)
            if copy:
                device_sim._fetch_host(
                    [t for part in state if part is not None
                     for t in part] + cols)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / q * 1e3

    calls = 0

    def one(way: str) -> float:
        nonlocal calls
        calls += 1
        if way == "warm":
            return float(sim.run(q, repeats=1).policy_s[0]) * 1e3
        if way == "cold":
            return float(sim.run(q, warmup=False).policy_s[0]) * 1e3
        if way == "ckpt":
            return float(run_device_sim_checkpointed(
                sim, q, SEG, f"{tmp.name}/{calls}").policy_s[0]) * 1e3
        return segmented(copy=(way == "copies"))

    for way in WAYS:                       # every path built and run once
        one(way)
    times = {way: [] for way in WAYS}
    order = list(WAYS) + list(reversed(WAYS))
    for rnd in range(3):
        for way in order:
            times[way].append(one(way))
        print(json.dumps({"round": rnd, **{w: times[w][-2:]
                                           for w in WAYS}}), flush=True)
    for way in WAYS:
        t = np.array(times[way])
        print(f"{way:9s} median {np.median(t):8.3f} ms a quantum, spread "
              f"{t.max() - t.min():7.3f} over {t.size} runs", flush=True)
    tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())

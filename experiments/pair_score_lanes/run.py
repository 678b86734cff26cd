"""Time the one-lane ``pair_score`` kernel of two or more checkouts in
turns on one card: whether adding the lane axis moved a single lane's time.

Needs an NVIDIA GPU (``sm_90a``) and ``nvcc``; from the root of this
checkout::

    python3 experiments/pair_score_lanes/run.py ROOT_A ROOT_B [ROOT_C ...]

Each ROOT is the root of a checkout of the repository.  Each round builds
that checkout's kernel from its own source (into its own
``build/repro_torch/``) and times it in a process of its own, at the open
path's shape (P = 1032, n_valid = 1024, four categories, 5% of the slots
empty, the idle vertex at row 1024 as a host int, one lane, seeded
inputs): CUDA events over 200 back-to-back launches after a warm-up, and
a hash of the output.  Rounds run forward and back, twice (A, B, C, C, B,
A, A, B, C, C, B, A for three).  Prints the card's name and power limit,
each round's time and the median and spread per checkout; exits non-zero
if the checkouts' outputs differ.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import hashlib, json
import numpy as np
import torch
from repro_torch.kernels.pair_score import kernel

dev = torch.device("cuda")
rng = np.random.default_rng(14)
p, n_valid = 1032, 1024
st = torch.as_tensor(rng.dirichlet(np.ones(4), size=n_valid)
                     .astype(np.float32), device=dev)
valid = torch.as_tensor(rng.random(n_valid) > 0.05, device=dev)
coeffs = torch.as_tensor(rng.normal(0.3, 0.5, (4, 4)).astype(np.float32),
                         device=dev)

def call():
    return kernel.pair_score_cuda(st, coeffs, 4, n_valid, valid, n_valid, p)

out = call()
for _ in range(5):
    call()
torch.cuda.synchronize()
torch.cuda._sleep(200_000_000)
start = torch.cuda.Event(enable_timing=True)
end = torch.cuda.Event(enable_timing=True)
start.record()
for _ in range(200):
    call()
end.record()
torch.cuda.synchronize()
print(json.dumps({"ms": start.elapsed_time(end) / 200,
                  "hash": hashlib.sha256(out.cpu().numpy().tobytes())
                  .hexdigest()}))
"""


def _round(root: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=root,
                         env=dict(os.environ, PYTHONPATH=str(root / "src")),
                         capture_output=True, text=True, check=True,
                         timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    import numpy as np

    roots = [Path(a).resolve() for a in sys.argv[1:]]
    if len(roots) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    times = {k: [] for k in range(len(roots))}
    hashes = set()
    there = list(range(len(roots)))
    for k in (there + there[::-1]) * 2:
        r = _round(roots[k])
        times[k].append(r["ms"])
        hashes.add(r["hash"])
        print(f"[lanes] {roots[k].name}: {r['ms'] * 1e3:.3f} us", flush=True)
    for k, ms in times.items():
        print(f"[lanes] {roots[k].name}: median "
              f"{float(np.median(ms)) * 1e3:.3f} us, spread "
              f"{(max(ms) - min(ms)) * 1e3:.3f} us", flush=True)
    print(f"[lanes] outputs identical: {len(hashes) == 1}", flush=True)
    return 0 if len(hashes) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())

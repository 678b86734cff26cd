"""``layers.dot``'s two routes on the card, at the benchmark cells' product
shapes (``tests/test_torch_dot_gpu.py``'s ``SHAPES``).

For each shape, with bfloat16 operands drawn from a seed:

* the float32 route (both operands upcast, a float32 GEMM) and the
  tensor-core route (``torch.mm(..., out_dtype=float32)``), each timed by
  CUDA events over ``--iters`` launches after a warm-up, as ms a product
  and TFLOP/s (2 k n FLOPs a row); the upcasts are part of the float32
  route's time, as in ``dot``;
* each route's error against float64 products of the same values, as the
  least ``K`` for which ``|y - y64| <= K * 2**-23 * (|x| @ |w|)`` holds
  elementwise (the tensor-core test asks for ``K = k``), and the largest
  ``|y - y64|`` over the largest ``|y64|``;

then one forward of 256 tokens of the full starcoder2-3b and rwkv6-3b in
bfloat16 (weights drawn from seed 0, flash attention as the benchmark
runs it), counting the products each route took (``layers.
DOT_TENSOR_CORE``, ``layers.DOT_FLOAT32``).

Needs an NVIDIA GPU (about a minute on an H100)::

    python3 experiments/dot_routes/run.py [--iters 20] [--json out.json]

prints one ``[dot]`` line a shape and route, and a ``[dot-count]`` line a
model.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

import torch  # noqa: E402

from repro_torch.models import layers  # noqa: E402
from repro_torch.models.registry import build_model, get_config  # noqa: E402
from test_torch_dot_gpu import CHUNK, SHAPES, _operands  # noqa: E402


def _float32_route(x2d, w):
    return x2d.float() @ w.float()


def _tensor_core_route(x2d, w):
    return torch.mm(x2d, w, out_dtype=torch.float32)


def _time_ms(fn, iters):
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _errors(x2d, w, y):
    """The least K of the float32 sum's bound, and max |y - y64| over
    max |y64|."""
    k = x2d.shape[1]
    w64 = w.double()
    least_k, gap, top = 0.0, 0.0, 0.0
    for r in range(0, x2d.shape[0], CHUNK):
        xs = x2d[r:r + CHUNK].double()
        y64 = xs @ w64
        err = (y[r:r + CHUNK].double() - y64).abs()
        unit = 2.0 ** -23 * (xs.abs() @ w64.abs())
        least_k = max(least_k, float((err / unit.clamp_min(1e-300)).max()))
        gap, top = max(gap, float(err.max())), max(top, float(y64.abs().max()))
    return least_k, gap / top, k


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dot_routes: needs an NVIDIA GPU with CUDA")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[dot] card {card.strip()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    dev = torch.device("cuda")
    rows = []
    with torch.no_grad():
        for name, lead, k, n in SHAPES:
            x, w = _operands(lead, k, n, dev)
            x2d = x.reshape(-1, k)
            flops = 2.0 * x2d.shape[0] * k * n
            for route, fn in (("float32", _float32_route),
                              ("tensor_core", _tensor_core_route)):
                ms = _time_ms(lambda: fn(x2d, w), args.iters)
                least_k, rel, _ = _errors(x2d, w, fn(x2d, w))
                row = dict(shape=name, rows=x2d.shape[0], k=k, n=n,
                           route=route, ms=ms, tflops=flops / ms / 1e9,
                           least_K=least_k, K_over_k=least_k / k,
                           max_err_over_max_y=rel)
                rows.append(row)
                print("[dot] " + " ".join(f"{a}={b}" for a, b in row.items()),
                      flush=True)
                torch.cuda.empty_cache()
        for arch in ("starcoder2-3b", "rwkv6-3b"):
            cfg = get_config(arch, attention_impl="kernel")
            model = build_model(cfg, device=dev, seed=0)
            tokens = torch.randint(0, cfg.vocab_size, (1, 256), device=dev)
            before = (layers.DOT_TENSOR_CORE, layers.DOT_FLOAT32)
            model.forward({"tokens": tokens})
            torch.cuda.synchronize()
            row = dict(model=arch, layers=cfg.n_layers, dtype=cfg.dtype,
                       tensor_core=layers.DOT_TENSOR_CORE - before[0],
                       float32=layers.DOT_FLOAT32 - before[1])
            rows.append(row)
            print("[dot-count] " + " ".join(f"{a}={b}"
                                            for a, b in row.items()),
                  flush=True)
            del model
            torch.cuda.empty_cache()
    if args.json:
        Path(args.json).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()

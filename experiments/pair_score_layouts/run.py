"""Time the layouts tried for the ``pair_score`` kernel against the kept one.

Needs an NVIDIA H100 (``sm_90a``) and ``nvcc``; from the root of the
checkout::

    PYTHONPATH=src python3 experiments/pair_score_layouts/run.py

Builds every ``.cu`` here (one ``nvcc`` each, all at once) into
``build/repro_torch/layouts/`` and the kept kernel through
``repro_torch.kernels.pair_score.kernel``.  Then:

* bits: at P in 2 ... 8200, C in {3, 4}, every layout's output, unfused
  and fused (a valid mask with empty slots, the idle vertex at row
  n_valid), must equal the kept kernel's bit for bit, and the kept kernel's
  unfused output must equal ``old.cu``'s (the first port's costs);
* times at the race's shape (P = 1032, n_valid = 1024, C = 4): CUDA events
  over 200 back-to-back launches, three rounds in alternating order, and
  each kernel's own duration under ``torch.profiler`` (50 launches).

Layouts: ``old.cu`` (the first port: 32 x 32 tiles, no epilogue),
``band.cu`` (one wave of row-band pairs, 16-byte stores), ``tile_a.cu``
(``old.cu`` with the fused epilogue), ``tile_b.cu`` (16-byte stores, tiles
of 32 x 32, 16 x 64 and 8 x 128), ``tile_c.cu`` (``tile_a`` with a
block-uniform fast path, 2, 4 or 8 rows a thread), ``tile_s_bulk.cu`` (the
kept kernel with bulk stores from shared memory).  Prints one line per
check and time; exits non-zero if a build fails or a layout's bits differ.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels._build import BUILD_DIR, NVCC_FLAGS, _nvcc
from repro_torch.kernels.pair_score import kernel

HERE = Path(__file__).resolve().parent
OUT = BUILD_DIR / "layouts"
PTR, INT = ctypes.c_void_p, ctypes.c_int
NEW_ARGS = [PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, PTR]
SIZES = [2, 33, 129, 264, 1032, 4104, 8200]
#: name -> (source stem, entry point); every entry takes NEW_ARGS.
LAYOUTS = {
    "band": ("band", "pair_score_launch"),
    "A": ("tile_a", "launch_a"),
    "B 32x32": ("tile_b", "launch_b1"),
    "B 16x64": ("tile_b", "launch_b2"),
    "B 8x128": ("tile_b", "launch_b3"),
    "C 2 rows": ("tile_c", "launch_c2"),
    "C 4 rows": ("tile_c", "launch_c4"),
    "C 8 rows": ("tile_c", "launch_c8"),
    "kept, bulk stores": ("tile_s_bulk", "launch_s_bulk"),
}


def build():
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {src.stem: subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(OUT / f"{src.stem}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in sorted(HERE.glob("*.cu"))}
    kernel.LIB.load()
    libs = {}
    for stem, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log)
            raise SystemExit(f"nvcc failed on {stem}.cu")
        for ln in log.splitlines():
            if "Used" in ln:
                print(f"ptxas {stem}: {ln.split(':', 1)[1].strip()}")
        libs[stem] = ctypes.CDLL(str(OUT / f"{stem}.so"))
    libs["old"].pair_score_launch.argtypes = [PTR, PTR, PTR, INT, INT, INT,
                                              PTR]
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    libs = build()
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def layout(stem, entry):
        fn = getattr(libs[stem], entry)
        fn.argtypes = NEW_ARGS

        def call(st, coeffs, p, n_valid, n_cat, valid, idle):
            out = torch.empty((p, p), device=dev)
            rc = fn(st.data_ptr(), coeffs.data_ptr(),
                    None if valid is None else valid.data_ptr(),
                    out.data_ptr(), p, n_valid, n_cat, idle, n_sm,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{stem}.{entry}: cudaError {rc}")
            return out
        return call

    def old(st, coeffs, p, n_valid, n_cat):
        out = torch.empty((p, p), device=dev)
        rc = libs["old"].pair_score_launch(
            st.data_ptr(), coeffs.data_ptr(), out.data_ptr(), p, n_valid,
            n_cat, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"old.cu: cudaError {rc}")
        return out

    def kept(st, coeffs, p, n_valid, n_cat, valid, idle):
        return kernel.pair_score_cuda(st, coeffs, n_cat, n_valid, valid,
                                      idle, p)

    fns = {name: layout(*where) for name, where in LAYOUTS.items()}
    rng = np.random.default_rng(0)
    failed = 0
    for p in SIZES:
        n_valid = max(1, p - 1 - p // 64)
        for n_cat in (4, 3):
            st = torch.as_tensor(
                rng.dirichlet(np.ones(4), size=p).astype(np.float32) * 2.5,
                device=dev)
            coeffs = torch.as_tensor(
                rng.normal(0.3, 0.5, (4, 4)).astype(np.float32), device=dev)
            valid = torch.as_tensor(rng.random(n_valid) > 0.15, device=dev)
            valid[n_valid - 1] = False
            idle = n_valid if n_valid < p else -1
            unfused = (st, coeffs, p, n_valid, n_cat, None, -1)
            fused = (st[:n_valid].clone(), coeffs, p, n_valid, n_cat, valid,
                     idle)
            w_unf, w_fus = kept(*unfused), kept(*fused)
            same = {"old (unfused)": torch.equal(
                old(st, coeffs, p, n_valid, n_cat), w_unf)}
            for name, fn in fns.items():
                if name == "kept, bulk stores" and p % 4:
                    continue
                same[name] = (torch.equal(fn(*unfused), w_unf)
                              and torch.equal(fn(*fused), w_fus))
            bad = [k for k, v in same.items() if not v]
            failed += len(bad)
            print(f"bits P={p} n_valid={n_valid} C={n_cat}: "
                  f"{len(same) - len(bad)} of {len(same)} layouts equal to "
                  f"the kept kernel{'; differ: ' + ', '.join(bad) if bad else ''}")

    p, n_valid = 1032, 1024
    st = torch.as_tensor(
        rng.dirichlet(np.ones(4), size=n_valid).astype(np.float32),
        device=dev)
    st_p = torch.cat([st, st[: p - n_valid]])
    coeffs = torch.as_tensor(rng.normal(0.3, 0.5, (4, 4)).astype(np.float32),
                             device=dev)
    valid = torch.ones(n_valid, dtype=torch.bool, device=dev)
    calls = {"old (unfused)": lambda: old(st_p, coeffs, p, n_valid, 4)}
    for name, fn in (("kept", kept), *fns.items()):
        calls[f"{name} fused"] = (
            lambda fn=fn: fn(st, coeffs, p, n_valid, 4, valid, -1))
        calls[f"{name} unfused"] = (
            lambda fn=fn: fn(st_p, coeffs, p, n_valid, 4, None, -1))
    fill = torch.empty((p, p), device=dev)
    calls["torch fill_ of the (P, P) output"] = lambda: fill.fill_(1.0)

    def events_us(fn, iters=200):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters * 1e3

    order = list(calls)
    times = {k: [] for k in order}
    for rnd in range(3):
        for k in (order if rnd % 2 == 0 else order[::-1]):
            times[k].append(events_us(calls[k]))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for k in order:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(50):
                calls[k]()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        n = sum(e.count for e in seen)
        us = sum(getattr(e, "self_device_time_total", 0.0)
                 or e.self_cuda_time_total for e in seen)
        print(f"time P={p} n_valid={n_valid} C=4, {k}: "
              + ", ".join(f"{t:.3f}" for t in times[k])
              + f" us (CUDA events, 200 launches, 3 rounds); "
              f"{us / max(n, 1):.3f} us a launch under the profiler")
    print(f"layouts whose bits differ: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each printed as it ends; any failure raises and exits non-zero:

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
2. build every hand-written kernel from the checkout's sources (``nvcc``
   for ``sm_90a`` into ``build/repro_torch/``) and print the build time and
   the compiler's register/shared-memory report;
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and a few others (2e-5 abs/rel, sentinels exact);
4. fit the ``SYNPA4_R-FEBE`` Eq. 4 model with the port's own profiling
   campaign (default campaign, ``MachineParams()``, machine seed 0);
5. a small race (N = 16) on the card against the same race on the CPU,
   both fed the same draws: the reference check of the whole path;
6. the main path: the cluster-scale closed race, N = 1024 applications
   (``scaled_workload(1024, seed=1024)``), 8 quanta, seed 3, policies
   ``linux``/``random``/``synpa4``, through ``run_quanta_scan``, with every
   kernel's launch count set to 0 just before and read just after; then an
   audit of the host synchronisations of one race, its per-quantum wall
   time (median of 3 timed runs after one warm run), a profiler
   breakdown of one race by kernel and a timing of each layer;
7. each kernel's time at the main path's shapes beside its plain
   version's time and the card's bound for the same work.

The line before the last is a JSON object listing every kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without a GPU, or without the
repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_APPS = 1024
N_QUANTA = 8
RACE_SEED = 3
TOL = 2e-5
#: Published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth and
#: float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def _line(tag: str, text: str) -> None:
    print(f"[{tag}] {text}", flush=True)


def _gpu_ms(fn, iters: int = 200) -> float:
    """Device time of one call of ``fn``: CUDA events around ``iters``
    back-to-back calls, queued behind a device-side sleep so that the
    host's launch time does not show as gaps between them."""
    import torch

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
    return start.elapsed_time(end) / iters


class HostDraws:
    """The port's default draws, made on the CPU and copied to ``device``:
    a race on the card and a race on the CPU then see the same numbers."""

    def __init__(self, seed: int, device):
        from repro_torch.smt.scan_engine import TorchDraws

        self._cpu = TorchDraws(seed, "cpu")
        self.device = device

    def noise(self, q, n):
        return self._cpu.noise(q, n).to(self.device)

    def phase(self, q, lam):
        return self._cpu.phase(q, lam.cpu()).to(self.device)

    def linux(self, k, q, n):
        return tuple(t.to(self.device) for t in self._cpu.linux(k, q, n))


def _policies(model, scan_engine, isc):
    return {
        "linux": scan_engine.ScanPolicy(kind="linux"),
        "random": scan_engine.ScanPolicy(kind="static"),
        "synpa4": scan_engine.ScanPolicy(kind="synpa",
                                         method=isc.SYNPA4_R_FEBE,
                                         model=model),
    }


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.core import isc, matching, regression
    from repro_torch.core.synpa import fused_pad, make_fused_step
    from repro_torch.kernels.pair_score import kernel as ps_kernel
    from repro_torch.kernels.pair_score.ref import DIAG, pair_costs_plain
    from repro_torch.smt import scan_engine, training
    from repro_torch.smt.machine import MachineParams, PhaseTables, SMTMachine
    from repro_torch.smt.workloads import scaled_workload

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. The card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    _line("device", f"{kind}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    # 2. Build.
    build_s = ps_kernel.load()
    _line("build", f"pair_score: {build_s:.2f} s "
          f"({ps_kernel.library_path().relative_to(ROOT)})")
    for ln in ps_kernel.BUILD_LOG.splitlines():
        if "ptxas" in ln:
            _line("build", ln.strip())

    # 3. Kernel against its plain version.
    max_err = 0.0
    rng = np.random.default_rng(0)
    coeffs_rand = torch.as_tensor(
        rng.normal(0.3, 0.5, (4, 4)).astype(np.float32), device=dev)
    for p, n_valid, n_cat in ((8, 8, 4), (264, 257, 3), (1032, 1024, 4),
                              (1032, 1032, 3)):
        st = torch.as_tensor(
            rng.dirichlet(np.ones(4), size=p).astype(np.float32), device=dev)
        got = ps_kernel.pair_score_cuda(st, coeffs_rand, n_cat, n_valid)
        want = pair_costs_plain(st, coeffs_rand, n_cat, n_valid)
        torch.cuda.synchronize()
        sentinel = want == DIAG
        if not torch.equal(got == DIAG, sentinel):
            raise AssertionError(f"pair_score P={p}: sentinel entries differ")
        diff = (got - want).abs()[~sentinel]
        bound = TOL + TOL * want.abs()[~sentinel]
        err = float(diff.max()) if diff.numel() else 0.0
        if not bool((diff <= bound).all()):
            raise AssertionError(f"pair_score P={p}: max abs err {err:.3e}")
        max_err = max(max_err, err)
        _line("kernel", f"pair_score P={p} n_valid={n_valid} C={n_cat}: "
              f"max abs err {err:.3e} (limit {TOL} abs/rel), sentinels exact")

    # 4. Fit the model.
    t0 = time.perf_counter()
    models, _ = training.build_all_models(
        SMTMachine(MachineParams(), seed=0),
        methods={"SYNPA4_R-FEBE": isc.SYNPA4_R_FEBE}, device=dev)
    model = models["SYNPA4_R-FEBE"]
    coeffs_txt = [[round(float(x), 4) for x in row]
                  for row in model.coeffs.cpu().numpy()]
    _line("fit", f"SYNPA4_R-FEBE in {time.perf_counter() - t0:.2f} s; "
          f"coeffs {coeffs_txt}")

    params = MachineParams()

    # 5. Reference check: the whole path at N = 16, card against CPU.
    small = scaled_workload(16, seed=16)
    on_card = scan_engine.run_quanta_scan(
        params, small, _policies(model, scan_engine, isc), n_quanta=N_QUANTA,
        seed=5, device=dev, draws=HostDraws(5, dev), repeats=0)
    on_cpu = scan_engine.run_quanta_scan(
        params, small, _policies(model.to("cpu"), scan_engine, isc),
        n_quanta=N_QUANTA, seed=5, device="cpu", draws=HostDraws(5, "cpu"),
        repeats=0)
    for name, r in on_card.items():
        c = on_cpu[name]
        for field in ("total_retired", "mean_true_slowdown"):
            a, b = getattr(r, field), getattr(c, field)
            if not abs(a - b) <= 1e-4 * abs(b):
                raise AssertionError(
                    f"N=16 {name}.{field}: card {a!r} vs CPU {b!r}")
        _line("reference", f"N=16 {name}: mean true slowdown card "
              f"{r.mean_true_slowdown!r} CPU {c.mean_true_slowdown!r}; "
              f"retired card {r.total_retired!r} CPU {c.total_retired!r}")

    # 6. The main path.
    profiles = scaled_workload(N_APPS, seed=N_APPS)
    policies = _policies(model, scan_engine, isc)
    ps_kernel.LAUNCHES = 0
    regression.NEED_FB_SYNCS = 0
    regression.FALLBACK_RUNS = 0
    matching.TWO_OPT_SYNCS = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = scan_engine.run_quanta_scan(
        params, profiles, policies, n_quanta=N_QUANTA, seed=RACE_SEED,
        device=dev, repeats=0)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"pair_score": ps_kernel.LAUNCHES}
    fb_syncs = regression.NEED_FB_SYNCS
    fb_in_race = regression.FALLBACK_RUNS
    two_opt_syncs = matching.TWO_OPT_SYNCS
    for name, r in res.items():
        if r.ipc.shape != (N_APPS,) or not np.isfinite(r.ipc).all():
            raise AssertionError(f"{name}: ipc not finite or wrong shape")
        if not math.isfinite(r.mean_true_slowdown) or r.mean_true_slowdown < 1:
            raise AssertionError(f"{name}: mean true slowdown "
                                 f"{r.mean_true_slowdown!r}")
        _line("race", f"N={N_APPS} {name}: mean true slowdown "
              f"{r.mean_true_slowdown!r}, IPC geomean {r.ipc_geomean!r}, "
              f"retired {r.total_retired!r}")
    _line("race", f"first run {main_s:.3f} s (builds the race, runs it "
          f"once); pair_score launches {launches['pair_score']}; host syncs: "
          f"fallback flag {fb_syncs}, 2-opt flag {two_opt_syncs}")
    if launches["pair_score"] < N_QUANTA - 1:
        raise AssertionError(f"pair_score launched {launches['pair_score']} "
                             f"times, expected >= {N_QUANTA - 1}")
    for other in ("random", "linux"):
        if not (res["synpa4"].mean_true_slowdown
                < res[other].mean_true_slowdown):
            raise AssertionError(f"synpa4 does not beat {other} on mean true "
                                 "slowdown")

    # Host synchronisations inside one race: every one must be a counted
    # data-dependent exit.
    tables = PhaseTables.build(profiles)
    race = scan_engine.build_race(tables, params, list(policies.values()),
                                  N_QUANTA, dev)
    p_pad = fused_pad(N_APPS)
    init_mpart = torch.as_tensor(np.stack([
        scan_engine._initial_mpart(N_APPS, p_pad,
                                   np.random.default_rng(RACE_SEED + 7919))
        for _ in policies]), device=dev)
    init_st = torch.as_tensor(np.stack(
        [scan_engine._uniform_stacks(s, N_APPS) for s in policies.values()]),
        device=dev)
    dt = scan_engine.DeviceTables.build(tables, dev)
    draws = scan_engine.TorchDraws(RACE_SEED, dev)
    torch.cuda.synchronize()

    def audited(fn):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return [str(w.message) for w in seen
                if "synchroniz" in str(w.message)]

    # One deliberate sync tells how many warnings a sync raises here.
    # A deliberate sync, read as the race reads its flags, must be seen.
    if not audited(lambda: bool(torch.ones(1, device=dev))):
        raise AssertionError("sync audit: a deliberate sync raised no warning")
    counted0 = regression.NEED_FB_SYNCS + matching.TWO_OPT_SYNCS
    seen = audited(lambda: race(dt, init_mpart, init_st, draws))
    torch.cuda.synchronize()
    counted = regression.NEED_FB_SYNCS + matching.TWO_OPT_SYNCS - counted0
    _line("syncs", f"one race: {len(seen)} sync warnings, {counted} syncs "
          "counted (fallback + 2-opt flags)")
    if len(seen) != counted:
        for msg in sorted(set(seen)):
            _line("syncs", msg[:200])
        raise AssertionError("uncounted host syncs in the race")

    # Per-quantum wall time: median of 3 timed runs after one warm run.
    timed = scan_engine.run_quanta_scan(
        params, profiles, policies, n_quanta=N_QUANTA, seed=RACE_SEED,
        device=dev, repeats=3)
    per_q = timed["synpa4"].machine_s_per_quantum
    same = all(timed[k].total_retired == res[k].total_retired for k in res)
    _line("race", f"wall per quantum (3 policies, median of 3 after a warm "
          f"run): {per_q * 1e3:.3f} ms; reruns identical: {same}")

    # Where one race's time goes, by kernel, under the profiler.
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        race(dt, init_mpart, init_st, draws)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    kernels_seen = [e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0.0)
                or getattr(e, "self_cuda_time_total", 0.0))

    busy_ms = sum(dev_us(e) for e in kernels_seen) / 1e3
    n_kernels = sum(e.count for e in kernels_seen)
    _line("profile", f"one race under the profiler: wall {prof_wall * 1e3:.3f}"
          f" ms, {n_kernels} kernels, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / (prof_wall * 1e3):.1f}% of the profiled wall, "
          f"{100 * busy_ms / (per_q * N_QUANTA * 1e3):.1f}% of the unprofiled"
          " one)")
    for e in sorted(kernels_seen, key=dev_us, reverse=True)[:12]:
        _line("profile", f"{dev_us(e) / 1e3:9.3f} ms  x{e.count:<6d} "
              f"{e.key[:100]}")

    # Where a synpa quantum's time goes, layer by layer, at N = 1024: host
    # clock around each call, synchronised after it, median of 5.
    def wall_ms(fn, reps=5):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out))

    quantum = scan_engine._make_machine_quantum(dt, params)
    state0 = scan_engine._MachineState(
        torch.zeros(N_APPS, dtype=torch.int64, device=dev),
        dt.duration[:, 0].clone(),
        torch.zeros(N_APPS, device=dev), torch.zeros(N_APPS, device=dev))
    partner0 = scan_engine._machine_partner_of(init_mpart[0], N_APPS)
    counters, _, _ = quantum(state0, partner0, draws, 0)
    fstep = make_fused_step(isc.SYNPA4_R_FEBE, model)
    solve = partner0 != torch.arange(N_APPS, device=dev)
    masks = torch.stack([solve, ~solve, torch.ones_like(solve),
                         torch.zeros_like(solve)])
    cost, _ = fstep(counters, partner0, init_st[0], masks, False)
    valid_p = torch.arange(p_pad, device=dev) < N_APPS
    matched = matching.device_pairs_partner(cost, valid_p, eps=1e-2,
                                            max_rounds=4 * (p_pad // 2))
    frac = isc.build_stack(isc.raw_stack(*counters[:, :4].T),
                           isc.SYNPA4_R_FEBE)
    firsts = solve & (torch.arange(N_APPS, device=dev) < partner0)
    fi, fj = frac[firsts], frac[partner0[firsts]]
    fb0 = regression.FALLBACK_RUNS
    layers = {
        "machine quantum": lambda: quantum(state0, partner0, draws, 1),
        "fused step, all": lambda: fstep(counters, partner0, init_st[0],
                                         masks, False),
        "  GN solve (8 LM steps)": lambda: regression._gn_solve(
            model, fi, fj, regression._log_init(fi),
            regression._log_init(fj), regression.GN_STEPS),
        "  heavy-ball fallback (2 x 80 steps)": lambda:
            regression._hb_best_of(model, fi, fj, 80, 1.5),
        "  pair_score kernel": lambda: regression.pair_cost_matrix(
            model, torch.cat([init_st[0], init_st[0][:p_pad - N_APPS]]),
            n_valid=N_APPS),
        "matcher, first quantum (seed + 2-opt)": lambda:
            matching.device_pairs_partner(cost, valid_p, eps=1e-2,
                                          max_rounds=4 * (p_pad // 2)),
        "matcher, refine (8 rounds)": lambda: matching.device_two_opt_partner(
            cost, matched, valid_p, eps=1e-2, max_rounds=8),
    }
    for name, fn in layers.items():
        _line("layers", f"{name:40s} {wall_ms(fn):9.3f} ms")
    fb_runs = regression.FALLBACK_RUNS - fb0
    _line("layers", f"the fused step above ran the fallback in {fb_runs} of 5 "
          f"calls; in the main race it ran in {fb_in_race} of "
          f"{N_QUANTA - 1} synpa quanta")

    # 7. Kernel time at the main path's shape: P = fused_pad(1024),
    # n_valid = 1024, four categories, the fitted coefficients.
    p, n_valid = p_pad, N_APPS
    st = torch.as_tensor(rng.dirichlet(np.ones(4), size=p).astype(np.float32),
                         device=dev)
    coeffs = model.coeffs.contiguous()
    ms = _gpu_ms(lambda: ps_kernel.pair_score_cuda(st, coeffs, 4, n_valid))
    plain_ms = _gpu_ms(lambda: pair_costs_plain(st, coeffs, 4, n_valid))
    n_bytes = p * 4 * 4 + 16 * 4 + p * p * 4
    # 17 operations per category and entry, 5 for the clips and the sum,
    # on the valid off-diagonal entries (the rest are sentinel stores).
    n_ops = (17 * 4 + 5) * n_valid * (n_valid - 1)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    _line("kernel", f"pair_score P={p}: {ms * 1e3:.3f} us, plain "
          f"{plain_ms * 1e3:.3f} us, bound {bound_ms * 1e3:.3f} us "
          f"({n_bytes} B, {n_ops} f32 ops); no single PyTorch call computes "
          "this function")

    kernels = [{
        "name": "pair_score",
        "route": "cuda",
        "source": "src/repro_torch/kernels/pair_score/csrc/pair_score.cu",
        "replaces": "src/repro/kernels/pair_score/kernel.py:27",
        "launches": launches["pair_score"],
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]
    _line("done", f"{time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

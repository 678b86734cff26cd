"""The port's free-running draws on the card (``TorchDraws`` on a CUDA
``torch.Generator``, which draws other numbers than the CPU's) against the
reference's distributions, as ``tests/test_torch_scan_engine.py`` holds the
CPU's:

* the counter noise's log-ratio over 200 quanta has mean 0 (within three
  standard errors) and standard deviation ``noise_sigma`` (within 5%);
* the phase-length draws at the pool's means, standardised as
  ``(x - lam) / sqrt(lam)`` over 200 quanta, have mean 0 (within three
  standard errors) and variance 1 (within 5%), as Poisson(lam) draws do;
* a free-running static race at N = 64 over 40 quanta agrees with the
  CPU's free-running race (which the CPU test holds to the reference
  engine) on mean true slowdown and IPC geomean within 3%.

This file imports nothing of JAX, so it runs where the port runs::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_scan_engine_gpu.py
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.smt import machine as tmc  # noqa: E402
from repro_torch.smt import scan_engine as tse  # noqa: E402
from repro_torch.smt import workloads as twl  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_counter_noise_lognormal_moments(cuda):
    params = tmc.MachineParams()
    n = 64
    dt = tse.DeviceTables.build(
        tmc.PhaseTables.build(twl.scaled_workload(n, seed=n)), cuda)
    idx = torch.arange(n, device=cuda)
    ph = torch.zeros(n, dtype=torch.int64, device=cuda)
    comps = tse._corun_components_scan(dt, ph, idx.flip(0), params)
    cycles = float(np.float32(params.quantum_cycles))
    base = tse._pmu_counters_scan(comps, dt.omega, dt.retire, cycles, params)
    draws = tse.TorchDraws(0, cuda)
    logs = torch.cat([torch.log(tse._pmu_counters_scan(
        comps, dt.omega, dt.retire, cycles, params, draws.noise(q, n))[:, 1:]
        / base[:, 1:]).ravel() for q in range(200)]).double().cpu().numpy()
    sigma = params.noise_sigma
    assert abs(logs.mean()) < 3 * sigma / math.sqrt(logs.size)
    assert abs(logs.std() - sigma) < 0.05 * sigma


@pytest.mark.gpu
def test_card_phase_draws_poisson_moments(cuda):
    n = 64
    dt = tse.DeviceTables.build(
        tmc.PhaseTables.build(twl.scaled_workload(n, seed=n)), cuda)
    live = (torch.arange(dt.duration.shape[1], device=cuda)
            < dt.n_phases[:, None])
    lam = dt.duration[live]
    draws = tse.TorchDraws(0, cuda)
    x = torch.stack([draws.phase(q, lam) for q in range(200)]).double()
    assert bool((x >= 0).all()) and bool((x == x.round()).all())
    z = ((x - lam.double()) / lam.double().sqrt()).cpu().numpy().ravel()
    assert abs(z.mean()) < 3 / math.sqrt(z.size)
    assert abs(z.var() - 1.0) < 0.05


@pytest.mark.gpu
def test_card_static_race_matches_the_cpu(cuda):
    profs = twl.scaled_workload(64, seed=64)
    pol = {"static": tse.ScanPolicy(kind="static")}
    card, cpu = (tse.run_quanta_scan(tmc.MachineParams(), profs, pol,
                                     n_quanta=40, seed=9, device=where,
                                     repeats=0)["static"]
                 for where in (cuda, "cpu"))
    assert card.mean_true_slowdown == pytest.approx(cpu.mean_true_slowdown,
                                                    rel=0.03)
    assert card.ipc_geomean == pytest.approx(cpu.ipc_geomean, rel=0.03)

"""The host tier on the card against the same runs on the CPU:

* ``SynpaScheduler`` on ``cuda`` against ``device="cpu"`` on the paper's
  workload ``fb0`` (N = 8): the same pairing every quantum, equal
  turnaround (the machine is numpy, so the runs are equal while the
  pairings are);
* ``StreamingAllocator`` through ``ClusterSim(engine="host")`` at
  capacity 16 on both: the same pairs every quantum and the same job logs;
* one SYNPA quantum launches the ``pair_score`` kernel exactly once and
  copies the cost matrix to the host exactly once.

This file imports nothing of JAX, so it runs where the port runs::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_host_tier_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import isc, synpa  # noqa: E402
from repro_torch.kernels.pair_score import kernel as ps_kernel  # noqa: E402
from repro_torch.online import (ClusterSim, PoissonArrivals,  # noqa: E402
                                StreamingAllocator)
from repro_torch.smt import training, workloads  # noqa: E402
from repro_torch.smt.apps import pool_profiles  # noqa: E402
from repro_torch.smt.machine import MachineParams, SMTMachine  # noqa: E402


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    models, _ = training.build_all_models(
        SMTMachine(MachineParams(), seed=0),
        methods={"SYNPA4_R-FEBE": isc.SYNPA4_R_FEBE}, device="cpu")
    return models["SYNPA4_R-FEBE"]


def _logged(policy, method):
    log = []
    inner = getattr(policy, method)

    def logged(*args, **kw):
        out = inner(*args, **kw)
        log.append(out)
        return out

    setattr(policy, method, logged)
    return log


@pytest.mark.gpu
def test_synpa_scheduler_card_matches_cpu(model):
    names = workloads.make_workloads(SMTMachine(seed=0))["fb0"]
    profs = workloads.workload_profiles(names)
    out, logs = {}, {}
    for dev in ("cuda", "cpu"):
        pol = synpa.SynpaScheduler(isc.SYNPA4_R_FEBE, model, device=dev)
        logs[dev] = _logged(pol, "schedule")
        out[dev] = SMTMachine(seed=0).run_workload(profs, pol, seed=11)
    assert logs["cuda"] == logs["cpu"]
    np.testing.assert_allclose(out["cuda"].turnaround_s,
                               out["cpu"].turnaround_s, rtol=1e-5)


@pytest.mark.gpu
def test_streaming_allocator_card_matches_cpu(model):
    pool = pool_profiles()
    stats, logs = {}, {}
    for dev in ("cuda", "cpu"):
        alloc = StreamingAllocator(isc.SYNPA4_R_FEBE, model, device=dev)
        logs[dev] = _logged(alloc, "pair")
        sim = ClusterSim(SMTMachine(seed=0), pool, 8, alloc,
                         PoissonArrivals(rate=2.0, n_pool=len(pool)), seed=5,
                         target_scale=0.1, device=dev)
        stats[dev] = sim.run(40)
    assert logs["cuda"] == logs["cpu"]
    a, b = stats["cuda"], stats["cpu"]
    assert [(r.job_id, r.admit_q, r.retries) for r in a.completed] == \
        [(r.job_id, r.admit_q, r.retries) for r in b.completed]
    np.testing.assert_allclose([r.finish_q for r in a.completed],
                               [r.finish_q for r in b.completed], rtol=1e-5)
    for f in ("queue_depth", "active", "solo_quanta", "admissions"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.gpu
def test_one_quantum_one_launch_one_copy(model):
    profs = workloads.scaled_workload(16, seed=4)
    pol = synpa.SynpaScheduler(isc.SYNPA4_R_FEBE, model)
    launches, copies = [], []

    def counted(q, samples, prev):
        l0, c0 = ps_kernel.LAUNCHES, synpa.HOST_COST_COPIES
        out = inner(q, samples, prev)
        launches.append(ps_kernel.LAUNCHES - l0)
        copies.append(synpa.HOST_COST_COPIES - c0)
        return out

    inner = pol.schedule
    pol.schedule = counted
    SMTMachine(seed=0).run_quanta(profs, pol, n_quanta=5, seed=2)
    # The first quantum has no counters yet: a random pairing, no step.
    assert launches == [0, 1, 1, 1, 1] and copies == [0, 1, 1, 1, 1]

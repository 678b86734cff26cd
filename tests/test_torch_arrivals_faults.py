"""The port's numpy copies for the open system draw the reference's
numbers: ``online/arrivals.py`` (``presample`` of every traffic model),
``online/faults.py`` (schedules and their context views), the §6.2 job
targets of ``smt/machine.py``, ``smt/workloads.solo_stack`` and the job
records and statistics of ``smt/metrics.py``.  All exact, over several
seeds."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import isc as jisc  # noqa: E402
from repro.online import arrivals as jarr  # noqa: E402
from repro.online import faults as jflt  # noqa: E402
from repro.smt import machine as jmc  # noqa: E402
from repro.smt import metrics as jmet  # noqa: E402
from repro.smt import workloads as jwl  # noqa: E402
from repro.smt.apps import pool_profiles as j_pool  # noqa: E402
from repro_torch.core import isc as tisc  # noqa: E402
from repro_torch.online import arrivals as tarr  # noqa: E402
from repro_torch.online import faults as tflt  # noqa: E402
from repro_torch.smt import machine as tmc  # noqa: E402
from repro_torch.smt import metrics as tmet  # noqa: E402
from repro_torch.smt import workloads as twl  # noqa: E402
from repro_torch.smt.apps import pool_profiles as t_pool  # noqa: E402

SEEDS = [0, 5, 11, 4242]


def _traffic(mod, n_pool):
    """The same traffic models built from either package."""
    return {
        "poisson": mod.PoissonArrivals(rate=2.5, n_pool=n_pool),
        "poisson_weighted_burst": mod.PoissonArrivals(
            rate=1.2, n_pool=n_pool, weights=np.arange(1, n_pool + 1),
            burst_every=7, burst_size=5),
        "trace": mod.TraceArrivals([(3, 1), (0, 4), (3, 2), (9, 0)]),
        "batch": mod.InitialBatch([0, 3, 3, 7]),
    }


@pytest.mark.parametrize("kind", ["poisson", "poisson_weighted_burst",
                                  "trace", "batch"])
@pytest.mark.parametrize("seed", SEEDS)
def test_presample_draws_the_same_numbers(kind, seed):
    want = jarr.presample(_traffic(jarr, 24)[kind], 40,
                          np.random.default_rng(seed + 4242))
    got = tarr.presample(_traffic(tarr, 24)[kind], 40,
                         np.random.default_rng(seed + 4242))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert (np.diff(got[0]) >= 0).all()


def _profiles(mod, n_cores, quanta):
    """The fault grid of ``benchmarks/online_churn.py`` at this size."""
    k = max(1, n_cores // 8)
    down_q, up_q = quanta // 4, (3 * quanta) // 4
    crash = tuple((down_q + i % 3, i) for i in range(k))
    heal = tuple((up_q + i % 3, i) for i in range(k))
    band = tuple((c, quanta // 3, (2 * quanta) // 3, 0.5)
                 for c in range(n_cores - max(1, n_cores // 8), n_cores))
    return {
        "crash-wave": mod.FaultProfile(fail=crash, recover=heal),
        "mttf-churn": mod.FaultProfile(mttf_quanta=3.0 * quanta,
                                       mttr_quanta=quanta / 6.0),
        "stragglers": mod.FaultProfile(straggle=band),
        "combined": mod.FaultProfile(fail=crash, recover=heal, straggle=band,
                                     mttf_quanta=6.0 * quanta,
                                     mttr_quanta=quanta / 6.0,
                                     max_retries=1, backoff_quanta=0,
                                     preserve_progress=False),
    }


@pytest.mark.parametrize("name", ["crash-wave", "mttf-churn", "stragglers",
                                  "combined"])
@pytest.mark.parametrize("seed", SEEDS)
def test_fault_schedules_are_the_same(name, seed):
    n_cores, quanta = 16, 24
    jp = _profiles(jflt, n_cores, quanta)[name]
    tp = _profiles(tflt, n_cores, quanta)[name]
    assert tp.static_config == jp.static_config
    want = jp.schedule(quanta, n_cores, seed)
    got = tp.schedule(quanta, n_cores, seed)
    for view in ("ctx_up", "ctx_speed", "failures", "recoveries",
                 "straggling"):
        g, w = getattr(got, view)(), getattr(want, view)()
        assert g.dtype == w.dtype and g.shape == w.shape, view
        np.testing.assert_array_equal(g, w, err_msg=view)


def test_fault_constants_match():
    assert tflt.RETRY_NEVER == jflt.RETRY_NEVER
    assert tflt.RETRY_NEVER.dtype == jflt.RETRY_NEVER.dtype
    assert tflt.FAULT_SEED_OFFSET == jflt.FAULT_SEED_OFFSET
    assert tflt.FAULT_RNG_STREAM_VERSION == jflt.FAULT_RNG_STREAM_VERSION


def test_job_targets_and_solo_rates_match():
    jm = jmc.SMTMachine(jmc.MachineParams(), seed=0)
    tm = tmc.SMTMachine(tmc.MachineParams(), seed=0)
    for jp, tp in zip(j_pool(), t_pool()):
        assert tm.solo_retire_rate(tp) == jm.solo_retire_rate(jp)
        assert tm.target_instructions(tp) == jm.target_instructions(jp)


@pytest.mark.parametrize("quanta", [12, 40])
def test_solo_stack_matches(quanta):
    jm = jmc.SMTMachine(jmc.MachineParams(), seed=0)
    tm = tmc.SMTMachine(tmc.MachineParams(), seed=0)
    for jp, tp in zip(j_pool()[:8], t_pool()[:8]):
        for jmeth, tmeth in ((jisc.SYNPA4_R_FEBE, tisc.SYNPA4_R_FEBE),
                             (jwl._CLASSIFY_METHOD, twl._CLASSIFY_METHOD)):
            want = jwl.solo_stack(jm, jp, jmeth, quanta=quanta)
            got = twl.solo_stack(tm, tp, tmeth, quanta=quanta)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _logs(seed, n_jobs=40, quanta=30):
    rng = np.random.default_rng(seed)
    arrive = np.sort(rng.integers(0, quanta, n_jobs))
    admit = np.where(rng.random(n_jobs) < 0.9,
                     arrive + rng.integers(0, 3, n_jobs), -1)
    finish = np.where((admit >= 0) & (rng.random(n_jobs) < 0.8),
                      admit + rng.uniform(1, 10, n_jobs), np.inf)
    return dict(
        policy_name="p", quantum_s=0.1, quanta=quanta,
        app_names=[f"app{k % 5}" for k in range(n_jobs)],
        arrive_q=arrive, admit_q=admit, finish_q=finish.astype(np.float32),
        targets=rng.uniform(1e8, 1e9, n_jobs),
        solo_s=rng.uniform(0.5, 2.0, n_jobs),
        queue_depth=rng.integers(0, 9, quanta),
        active=rng.integers(0, 16, quanta),
        policy_s=np.full(quanta, 1e-3),
        solo_quanta=rng.integers(0, 2, quanta),
        retries=rng.integers(0, 3, n_jobs))


@pytest.mark.parametrize("seed", SEEDS)
def test_online_stats_from_device_logs_match(seed):
    logs = _logs(seed)
    want = jmet.OnlineStats.from_device_logs(**logs)
    got = tmet.OnlineStats.from_device_logs(**logs)
    assert [dataclasses.astuple(r) for r in got.completed] == \
        [dataclasses.astuple(r) for r in want.completed]
    for k, v in want.summary().items():
        np.testing.assert_equal(got.summary()[k], v, err_msg=k)
    for k, v in want.timelines().items():
        np.testing.assert_array_equal(got.timelines()[k], v, err_msg=k)
    for g, w in zip(got.ccdf(), want.ccdf()):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got.retry_ccdf(), want.retry_ccdf()):
        np.testing.assert_array_equal(g, w)
    grid = np.linspace(1.0, 4.0, 9)
    for g, w in zip(tmet.slowdown_ccdf(got.slowdowns, grid),
                    jmet.slowdown_ccdf(want.slowdowns, grid)):
        np.testing.assert_array_equal(g, w)

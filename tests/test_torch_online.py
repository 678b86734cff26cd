"""Parity of the open system ``repro_torch.online`` (``ClusterSim`` with
``engine="scan"``) with the reference's ``repro.online.device_sim``, run in
the same process on the CPU.

Random draws are data: the port is fed the reference's own threefry draws
(:class:`test_torch_scan_engine.JaxDraws`, the keys of the reference's
open quantum).  The checks:

* ``adjacent`` on a single-phase pool at capacity 16: the whole trajectory
  (admission quanta, queue depth, active and solo counts) identical,
  finish quanta to rtol 1e-6;
* ``synpa4`` with the fitted ``SYNPA4_R-FEBE`` model at capacity 16 under
  churn that toggles the active population's parity, fifo and synergy
  admission: integer logs identical, finish quanta and mean slowdown to
  rtol 1e-4 (the ``full`` matcher, which re-seeds from float32 degree
  sums every quantum, is held to run, not to parity: ROADMAP §3);
* a ``crash-wave`` fault profile: retries, evictions, requeues and the
  conservation partition identical;
* ``SynergyAdmission``: pool cost within 1e-5, placement identical on
  tie-heavy inputs.

The reference runs are module-scoped fixtures, shared by the checks.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import isc as jisc  # noqa: E402
from repro.online import ClusterSim as JClusterSim  # noqa: E402
from repro.online import PoissonArrivals as JPoissonArrivals  # noqa: E402
from repro.online import SynergyAdmission as JSynergyAdmission  # noqa: E402
from repro.online import faults as jflt  # noqa: E402
from repro.smt import machine as jmc  # noqa: E402
from repro.smt import training as jtr  # noqa: E402
from repro.smt.apps import pool_profiles as j_pool  # noqa: E402
from repro.smt.scan_engine import ScanPolicy as JScanPolicy  # noqa: E402
from repro_torch.convert import category_model_from_numpy  # noqa: E402
from repro_torch.core import isc as tisc  # noqa: E402
from repro_torch.core import matching as tmat  # noqa: E402
from repro_torch.core import regression as treg  # noqa: E402
from repro_torch.kernels.pair_score import kernel as ps_kernel  # noqa: E402
from repro_torch.online import (  # noqa: E402
    ClusterSim,
    PoissonArrivals,
    SynergyAdmission,
)
from repro_torch.online import device_sim as tds  # noqa: E402
from repro_torch.online import faults as tflt  # noqa: E402
from repro_torch.smt import machine as tmc  # noqa: E402
from repro_torch.smt.apps import pool_profiles as t_pool  # noqa: E402
from repro_torch.smt.scan_engine import ScanPolicy  # noqa: E402
from test_torch_scan_engine import JaxDraws  # noqa: E402

N_CORES = 8            # capacity 16
ADJ_QUANTA = 60
SYN_QUANTA = 40
SEED = 11


def _single_phase(pool):
    return [dataclasses.replace(p, phases=(p.phases[0],)) for p in pool]


@pytest.fixture(scope="module")
def env():
    """Both packages' machines, pools and fitted SYNPA4_R-FEBE models."""
    jmach = jmc.SMTMachine(jmc.MachineParams(), seed=0)
    jmodels, _ = jtr.build_all_models(
        jmach, methods={"SYNPA4_R-FEBE": jisc.SYNPA4_R_FEBE})
    jm = jmodels["SYNPA4_R-FEBE"]
    tm = category_model_from_numpy(np.asarray(jm.coeffs), np.asarray(jm.mse),
                                   jm.n_categories, device="cpu")
    return dict(jmach=jmach, tmach=tmc.SMTMachine(tmc.MachineParams(), seed=0),
                jm=jm, tm=tm, jpool=j_pool(), tpool=t_pool())


@pytest.fixture(scope="module")
def synergy(env):
    j = JSynergyAdmission(env["jmach"], env["jpool"], jisc.SYNPA4_R_FEBE,
                          env["jm"], quanta=12)
    t = SynergyAdmission(env["tmach"], env["tpool"], tisc.SYNPA4_R_FEBE,
                         env["tm"], quanta=12)
    return j, t


def _crash_wave(mod, n_cores, quanta):
    """``benchmarks/online_churn.py``'s crash wave at this size: an eighth
    of the cores down a quarter in, back three quarters in."""
    k = max(1, n_cores // 8)
    crash = tuple((quanta // 4 + i % 3, i) for i in range(k))
    heal = tuple(((3 * quanta) // 4 + i % 3, i) for i in range(k))
    return mod.FaultProfile(fail=crash, recover=heal)


#: Synpa cases held to the reference: (admission, matcher, faults).
SYNPA_CASES = {
    "fifo": ("fifo", "refine", False),
    "synergy": ("synergy", "refine", False),
    "crash_wave": ("fifo", "refine", True),
}


def _run_pair(env, synergy, case):
    """The reference's run and the port's, on the same traffic and draws;
    the port's sync counters over its run."""
    jmach, tmach = env["jmach"], env["tmach"]
    if case == "adjacent":
        jpol, tpol = JScanPolicy(kind="adjacent"), ScanPolicy(kind="adjacent")
        jpool, tpool = _single_phase(env["jpool"]), _single_phase(env["tpool"])
        # Machines of their own: solo rates are cached by application
        # name, and the single-phase clones keep their originals' names.
        jmach = jmc.SMTMachine(jmc.MachineParams(), seed=0)
        tmach = tmc.SMTMachine(tmc.MachineParams(), seed=0)
        quanta, rate, scale, seed = ADJ_QUANTA, 1.2, 0.1, 5
        jkw, tkw = {}, {}
    else:
        admission, matcher, faulted = SYNPA_CASES[case]
        jpol = JScanPolicy(kind="synpa", method=jisc.SYNPA4_R_FEBE,
                           model=env["jm"], matcher=matcher)
        tpol = ScanPolicy(kind="synpa", method=tisc.SYNPA4_R_FEBE,
                          model=env["tm"], matcher=matcher)
        jpool, tpool = env["jpool"], env["tpool"]
        quanta, rate, scale, seed = SYN_QUANTA, 1.5, 0.08, SEED
        jkw = dict(admission=admission)
        tkw = dict(admission=admission)
        if admission == "synergy":
            jkw["synergy"], tkw["synergy"] = synergy
        if faulted:
            jkw["faults"] = _crash_wave(jflt, N_CORES, quanta)
            tkw["faults"] = _crash_wave(tflt, N_CORES, quanta)
    want = JClusterSim(jmach, jpool, N_CORES, jpol,
                       JPoissonArrivals(rate=rate, n_pool=len(jpool)),
                       seed=seed, target_scale=scale, engine="scan",
                       **jkw).run(quanta)
    before = (treg.NEED_FB_SYNCS, tmat.TWO_OPT_SYNCS, tds.ADMIT_SYNCS)
    got = ClusterSim(tmach, tpool, N_CORES, tpol,
                     PoissonArrivals(rate=rate, n_pool=len(tpool)),
                     seed=seed, target_scale=scale, engine="scan",
                     device="cpu", **tkw).run(quanta, draws=JaxDraws(seed),
                                              warmup=False)
    syncs = tuple(a - b for a, b in zip(
        (treg.NEED_FB_SYNCS, tmat.TWO_OPT_SYNCS, tds.ADMIT_SYNCS), before))
    return got, want, quanta, syncs


@pytest.fixture(scope="module")
def runs(env, synergy):
    return {case: _run_pair(env, synergy, case)
            for case in ["adjacent", *SYNPA_CASES]}


def _assert_integer_logs_equal(got, want):
    assert (got.n_arrived, got.n_admitted, got.n_completed) == \
        (want.n_arrived, want.n_admitted, want.n_completed)
    for series in ("queue_depth", "active", "solo_quanta", "arrivals",
                   "admissions", "departures"):
        np.testing.assert_array_equal(getattr(got, series),
                                      getattr(want, series), err_msg=series)
    gj = {r.job_id: (r.app_name, r.arrive_q, r.admit_q, r.retries)
          for r in got.completed}
    wj = {r.job_id: (r.app_name, r.arrive_q, r.admit_q, r.retries)
          for r in want.completed}
    assert gj == wj


def _finish(stats):
    return np.array([r.finish_q for r in sorted(stats.completed,
                                                key=lambda r: r.job_id)])


def test_adjacent_whole_trajectory(runs):
    got, want, quanta, syncs = runs["adjacent"]
    assert got.n_completed > 0 and got.solo_quanta.sum() > 0
    _assert_integer_logs_equal(got, want)
    np.testing.assert_allclose(_finish(got), _finish(want), rtol=1e-6)
    assert got.policy_name == "scan-adjacent"
    # The adjacent policy runs no solve, no matcher, no admission loop.
    assert syncs == (0, 0, 0)


@pytest.mark.parametrize("case", list(SYNPA_CASES))
def test_synpa_matches_reference(runs, case):
    got, want, quanta, syncs = runs[case]
    admission, _, _ = SYNPA_CASES[case]
    assert got.n_completed > 0
    # The churn toggles the active population's parity, so the idle
    # vertex joins and leaves the matching.
    assert 0 < got.solo_quanta.sum() < quanta
    _assert_integer_logs_equal(got, want)
    np.testing.assert_allclose(_finish(got), _finish(want), rtol=1e-4)
    np.testing.assert_allclose(got.mean_slowdown, want.mean_slowdown,
                               rtol=1e-4)
    # One fallback-flag read a quantum; synergy reads its trip count once
    # a quantum, fifo never.
    fb, _, admit = syncs
    assert fb == quanta
    assert admit == (quanta if admission == "synergy" else 0)


def test_full_matcher_runs(env):
    """``matcher="full"``: a sort seed and the full 2-opt every quantum,
    one fallback-flag read a quantum, jobs complete, and the idle vertex
    joins and leaves the matching."""
    pol = ScanPolicy(kind="synpa", method=tisc.SYNPA4_R_FEBE,
                     model=env["tm"], matcher="full")
    fb = treg.NEED_FB_SYNCS
    got = ClusterSim(env["tmach"], env["tpool"], N_CORES, pol,
                     PoissonArrivals(rate=1.5, n_pool=len(env["tpool"])),
                     seed=SEED, target_scale=0.08, engine="scan",
                     device="cpu").run(SYN_QUANTA, draws=JaxDraws(SEED),
                                       warmup=False)
    assert treg.NEED_FB_SYNCS - fb == SYN_QUANTA
    assert got.n_completed > 0 and 0 < got.solo_quanta.sum() < SYN_QUANTA
    assert np.isfinite(got.slowdowns).all() and got.mean_slowdown >= 1.0
    with pytest.raises(ValueError, match="matcher"):
        ClusterSim(env["tmach"], env["tpool"], N_CORES,
                   dataclasses.replace(pol, matcher="greedy"),
                   PoissonArrivals(rate=1.5, n_pool=len(env["tpool"])),
                   engine="scan", device="cpu").run(2, warmup=False)


def test_crash_wave_faults_match(runs):
    got, want, quanta, _ = runs["crash_wave"]
    assert got.has_faults and want.n_evicted > 0 and want.n_requeued > 0
    for series in ("evictions", "requeues", "failures", "recoveries",
                   "straggling"):
        np.testing.assert_array_equal(getattr(got, series),
                                      getattr(want, series), err_msg=series)
    assert (got.n_dropped, got.n_retry_waiting, got.n_in_flight) == \
        (want.n_dropped, want.n_retry_waiting, want.n_in_flight)
    # The conservation partition: every arrival is in exactly one state.
    queued = got.n_arrived - got.n_admitted
    assert got.n_arrived == (queued + got.n_completed + got.n_in_flight
                             + got.n_dropped + got.n_retry_waiting)


def test_conservation_check_catches_a_lost_job():
    """The faulted run's invariant check fails when a job is in no state
    (an admitted job that is neither done, waiting, dropped nor in
    flight cannot exist; one in two states is refused)."""
    prep = dict(j=2, fcfg=(3, 2, True))
    admit = np.array([0, 1])
    finish = np.array([5.5, np.inf], np.float32)
    retry_at = np.array([int(tds.RETRY_NEVER), 4])
    tds._check_conservation(prep, 8, admit, finish, np.array([0, 1]),
                            retry_at)
    with pytest.raises(AssertionError, match="conservation"):
        tds._check_conservation(prep, 8, admit, finish, np.array([0, 9]),
                                retry_at)


def test_synergy_admission_tables_match(synergy):
    jsyn, tsyn = synergy
    np.testing.assert_array_equal(tsyn.stacks, jsyn.stacks)
    np.testing.assert_allclose(tsyn.pool_cost, jsyn.pool_cost, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tsyn.mean_cost, jsyn.mean_cost, rtol=1e-5)
    assert (np.diag(tsyn.pool_cost) == tmat.BIG).all()
    np.testing.assert_array_equal(tsyn.hint(3), jsyn.hint(3))


@pytest.mark.parametrize("seed", range(4))
def test_synergy_place_matches_on_ties(synergy, seed):
    """Tie-heavy placement: residents drawn from three pool apps (so
    many free slots score the same), half the slots free; the chosen slot
    is the reference's, the lowest of the tied best."""
    jsyn, tsyn = synergy
    rng = np.random.default_rng(seed)
    c = 32
    app_id = np.where(rng.random(c) < 0.5, rng.choice([0, 5, 9], c), -1)
    for pid in (0, 5, 9, 17):
        free = np.flatnonzero(app_id < 0)
        assert tsyn.place(pid, free, app_id) == jsyn.place(pid, free, app_id)
    # Every mate empty: all free slots tie, the lowest wins.
    empty = np.full(c, -1)
    assert tsyn.place(4, [7, 3, 12], empty) == jsyn.place(4, [7, 3, 12],
                                                          empty) == 3


def test_free_running_draws_are_deterministic(env):
    """The port's own draws (``TorchDraws`` keyed from the seed): a rerun
    is identical, and the counter-driven tier beats the slot-ordered
    baseline on the same traffic."""
    runs = {}
    for name, pol in (("adjacent", ScanPolicy(kind="adjacent")),
                      ("synpa4", ScanPolicy(kind="synpa",
                                            method=tisc.SYNPA4_R_FEBE,
                                            model=env["tm"]))):
        sim = ClusterSim(env["tmach"], env["tpool"], N_CORES, pol,
                         PoissonArrivals(rate=1.2, n_pool=len(env["tpool"])),
                         seed=5, target_scale=0.1, engine="scan",
                         device="cpu")
        a, b = sim.run(SYN_QUANTA, warmup=False), sim.run(SYN_QUANTA,
                                                          warmup=False)
        assert a.mean_slowdown == b.mean_slowdown and a.n_completed > 0
        np.testing.assert_array_equal(a.queue_depth, b.queue_depth)
        runs[name] = a
    assert runs["synpa4"].mean_slowdown < runs["adjacent"].mean_slowdown


def test_cpu_run_launches_no_kernel(runs):
    """On the CPU the fused step takes ``pair_score``'s plain version: no
    kernel launch is counted."""
    before = ps_kernel.LAUNCHES
    assert runs["fifo"][0].n_completed > 0
    assert ps_kernel.LAUNCHES == before


def test_what_is_not_ported_raises(env):
    pool = env["tpool"]
    arr = PoissonArrivals(rate=1.0, n_pool=len(pool))
    # The host event loop is ported (open item 4): it runs an online
    # policy, and refuses a device-engine spec.
    from repro_torch.online.allocator import AdjacentOnline

    host = ClusterSim(env["tmach"], pool, 2, AdjacentOnline(), arr,
                      device="cpu")
    assert host.run(4).quanta == 4
    with pytest.raises(ValueError, match="OnlinePolicy"):
        ClusterSim(env["tmach"], pool, 2, ScanPolicy(kind="adjacent"), arr,
                   device="cpu")
    sim = ClusterSim(env["tmach"], pool, 2, ScanPolicy(kind="adjacent"), arr,
                     engine="scan", device="cpu")
    # The telemetry rings are ported (open item 1): they no longer raise.
    for kw in ({"telemetry": True}, {"app_telemetry": True}):
        assert sim.run(4, warmup=False, **kw).telemetry.quanta == 4
    with pytest.raises(ValueError):
        ClusterSim(env["tmach"], pool, 2, ScanPolicy(kind="linux"), arr,
                   engine="scan", device="cpu")
    with pytest.raises(ValueError):
        ClusterSim(env["tmach"], pool, 2, ScanPolicy(kind="adjacent"), arr,
                   engine="scan", device="cpu", admission="synergy")


def test_runs_on_cuda_unless_asked_for_the_cpu(env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pool = env["tpool"]
    args = (env["tmach"], pool, 2, ScanPolicy(kind="adjacent"),
            PoissonArrivals(rate=1.0, n_pool=len(pool)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClusterSim(*args, engine="scan")
    assert ClusterSim(*args, engine="scan", device="cpu").run(
        3, warmup=False).n_arrived >= 0

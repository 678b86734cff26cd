"""Parity of the port's lane-batched runs with the reference's:
``repro_torch.online.batch_sim.run_device_sim_batched`` against
``repro.online.batch_sim.run_device_sim_batched``, and
``repro_torch.smt.scan_engine.run_quanta_multi_batched`` against
``repro.smt.scan_engine.run_quanta_multi_batched``, in one process on the
CPU.

Random draws are data: lane i of the port is fed the reference's own
threefry draws of its seed (``LaneDraws`` of
:class:`test_torch_scan_engine.JaxDraws`).  With the fitted
``SYNPA4_R-FEBE`` model:

* one open grid mixes fifo and synergy lanes, faulted and healthy ones
  (capacity 8, 24 quanta): every lane's integer logs (admissions, queue
  depth, active and solo counts, retries, evictions, requeues) equal the
  reference lane's, finish quanta and mean slowdown to rtol 1e-4, and
  each lane equals the port's own ``run_device_sim`` of its scenario bit
  for bit;
* a grid whose lanes all admit by synergy, at different loads, matches
  the reference's lanes and the port's single runs the same way;
* adding lanes leaves the others unchanged, bit for bit;
* lanes that cannot share a run are refused;
* the closed race over seed lanes (N = 16 and 15, 8 quanta) matches the
  reference's lanes to rtol 1e-4 and the port's ``run_quanta_scan`` of
  each seed bit for bit, and a one-lane batch is ``run_quanta_scan``;
* the host syncs of a grid do not grow with its lanes.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import isc as jisc  # noqa: E402
from repro.online import ClusterSim as JClusterSim  # noqa: E402
from repro.online import FaultProfile as JFaultProfile  # noqa: E402
from repro.online import PoissonArrivals as JPoissonArrivals  # noqa: E402
from repro.online import SynergyAdmission as JSynergyAdmission  # noqa: E402
from repro.online.batch_sim import (  # noqa: E402
    run_device_sim_batched as j_batched)
from repro.smt import machine as jmc  # noqa: E402
from repro.smt import scan_engine as jse  # noqa: E402
from repro.smt import training as jtr  # noqa: E402
from repro.smt import workloads as jwl  # noqa: E402
from repro.smt.apps import pool_profiles as j_pool  # noqa: E402
from repro_torch.convert import category_model_from_numpy  # noqa: E402
from repro_torch.core import isc as tisc  # noqa: E402
from repro_torch.core import matching as tmat  # noqa: E402
from repro_torch.core import regression as treg  # noqa: E402
from repro_torch.online import (  # noqa: E402
    ClusterSim,
    FaultProfile,
    PoissonArrivals,
    SynergyAdmission,
    run_device_sim_batched,
)
from repro_torch.online import device_sim as tds  # noqa: E402
from repro_torch.online.device_sim import run_device_sim  # noqa: E402
from repro_torch.smt import machine as tmc  # noqa: E402
from repro_torch.smt import scan_engine as tse  # noqa: E402
from repro_torch.smt import workloads as twl  # noqa: E402
from repro_torch.smt.apps import pool_profiles as t_pool  # noqa: E402
from test_torch_online import (  # noqa: E402
    _assert_integer_logs_equal,
    _finish,
)
from test_torch_scan_engine import JaxDraws  # noqa: E402

QUANTA = 24
N_CORES = 4            # capacity 8
RACE_SEEDS = [3, 11, 42]
RACE_QUANTA = 8

#: The open grid's lanes: (seed, rate, admission, fault profile name).
LANES = [
    (5, 1.2, "fifo", None),
    (9, 1.8, "fifo", None),
    (5, 1.2, "synergy", None),
    (13, 1.8, "synergy", None),
    (5, 1.4, "fifo", "crash"),
    (7, 1.4, "fifo", "churn"),
]


def _faults(profile_cls, name):
    """The test's fault profiles, as either package's ``FaultProfile``."""
    if name == "crash":
        return profile_cls(fail=((3, 0), (4, 1)), recover=((8, 0),),
                           max_retries=2)
    if name == "churn":
        return profile_cls(mttf_quanta=6.0, mttr_quanta=3.0, max_retries=0,
                           preserve_progress=False)
    return None


@pytest.fixture(scope="module")
def env():
    """Both packages' machines, pools, tables, fitted SYNPA4_R-FEBE models
    and synergy admissions."""
    jmach = jmc.SMTMachine(jmc.MachineParams(), seed=0)
    jm = jtr.build_all_models(
        jmach, methods={"SYNPA4_R-FEBE": jisc.SYNPA4_R_FEBE})[0][
            "SYNPA4_R-FEBE"]
    tm = category_model_from_numpy(np.asarray(jm.coeffs), np.asarray(jm.mse),
                                   jm.n_categories, device="cpu")
    tmach = tmc.SMTMachine(tmc.MachineParams(), seed=0)
    jpool, tpool = j_pool(), t_pool()
    return dict(
        jmach=jmach, tmach=tmach, jm=jm, tm=tm, jpool=jpool, tpool=tpool,
        jtables=jmc.PhaseTables.build(jpool),
        ttables=tmc.PhaseTables.build(tpool),
        jspec=jse.ScanPolicy(kind="synpa", method=jisc.SYNPA4_R_FEBE,
                             model=jm),
        tspec=tse.ScanPolicy(kind="synpa", method=tisc.SYNPA4_R_FEBE,
                             model=tm),
        jsyn=JSynergyAdmission(jmach, jpool, jisc.SYNPA4_R_FEBE, jm,
                               quanta=12),
        tsyn=SynergyAdmission(tmach, tpool, tisc.SYNPA4_R_FEBE, tm,
                              quanta=12),
    )


def _tsim(env, seed, rate, admission="fifo", faults=None, n_cores=N_CORES,
          tables=None, spec=None):
    kw = dict(admission="synergy", synergy=env["tsyn"]) \
        if admission == "synergy" else {}
    return ClusterSim(env["tmach"], env["tpool"], n_cores,
                      spec or env["tspec"],
                      PoissonArrivals(rate=rate, n_pool=len(env["tpool"])),
                      seed=seed, target_scale=0.1,
                      tables=tables or env["ttables"],
                      faults=_faults(FaultProfile, faults), engine="scan",
                      device="cpu", **kw)


def _jsim(env, seed, rate, admission="fifo", faults=None):
    kw = dict(admission="synergy", synergy=env["jsyn"]) \
        if admission == "synergy" else {}
    return JClusterSim(env["jmach"], env["jpool"], N_CORES, env["jspec"],
                       JPoissonArrivals(rate=rate,
                                        n_pool=len(env["jpool"])),
                       seed=seed, target_scale=0.1, tables=env["jtables"],
                       faults=_faults(JFaultProfile, faults),
                       engine="scan", **kw)


def _draws(sims):
    return tse.LaneDraws([JaxDraws(s.seed) for s in sims])


def _assert_bitwise(a, b):
    _assert_integer_logs_equal(a, b)
    np.testing.assert_array_equal(_finish(a), _finish(b))
    assert a.mean_slowdown == b.mean_slowdown or (
        np.isnan(a.mean_slowdown) and np.isnan(b.mean_slowdown))


@pytest.fixture(scope="module")
def grid(env):
    """The reference's grid and the port's, on the same draws, with the
    port's sync counts over its run."""
    jsims = [_jsim(env, *lane) for lane in LANES]
    tsims = [_tsim(env, *lane) for lane in LANES]
    want = j_batched(jsims, QUANTA, warmup=False)
    before = (treg.NEED_FB_SYNCS, tmat.TWO_OPT_SYNCS, tds.ADMIT_SYNCS)
    got = run_device_sim_batched(tsims, QUANTA, warmup=False,
                                 draws=_draws(tsims))
    syncs = tuple(a - b for a, b in zip(
        (treg.NEED_FB_SYNCS, tmat.TWO_OPT_SYNCS, tds.ADMIT_SYNCS), before))
    return tsims, got, want, syncs


@pytest.mark.parametrize("kind", ["fifo", "synergy"])
def test_mixed_admission_lanes_match_reference(grid, kind):
    _, got, want, _ = grid
    lanes = [i for i, lane in enumerate(LANES)
             if lane[2] == kind and lane[3] is None]
    assert lanes
    for i in lanes:
        g, w = got[i], want[i]
        assert g.n_completed > 0
        _assert_integer_logs_equal(g, w)
        np.testing.assert_allclose(_finish(g), _finish(w), rtol=1e-4)
        np.testing.assert_allclose(g.mean_slowdown, w.mean_slowdown,
                                   rtol=1e-4)


def test_faulted_and_healthy_lanes_match_reference(grid):
    _, got, want, _ = grid
    faulted = [i for i, lane in enumerate(LANES) if lane[3] is not None]
    for i in faulted:
        g, w = got[i], want[i]
        assert g.has_faults and w.n_evicted > 0
        _assert_integer_logs_equal(g, w)
        np.testing.assert_allclose(_finish(g), _finish(w), rtol=1e-4)
        for series in ("evictions", "requeues", "failures", "recoveries",
                       "straggling"):
            np.testing.assert_array_equal(getattr(g, series),
                                          getattr(w, series), err_msg=series)
        assert (g.n_dropped, g.n_retry_waiting, g.n_in_flight) == \
            (w.n_dropped, w.n_retry_waiting, w.n_in_flight)
    # Fault stats attach to faulted lanes only.
    assert not any(got[i].has_faults for i in range(len(LANES))
                   if i not in faulted)


def test_lanes_equal_their_single_runs(grid):
    """Each lane is the port's own run of its scenario, bit for bit."""
    tsims, got, _, _ = grid
    for sim, g in zip(tsims, got):
        _assert_bitwise(g, run_device_sim(sim, QUANTA, warmup=False,
                                          draws=JaxDraws(sim.seed)))


def test_lane_count_is_a_shape(env, grid):
    """A sub-grid reproduces its lanes bit for bit, the lanes reordered
    and a one-lane grid included."""
    tsims, got, _, _ = grid
    pick = [3, 0, 5]
    sub = [tsims[i] for i in pick]
    for k, g in enumerate(run_device_sim_batched(sub, QUANTA, warmup=False,
                                                 draws=_draws(sub))):
        _assert_bitwise(g, got[pick[k]])
    one = run_device_sim_batched([tsims[2]], QUANTA, warmup=False,
                                 draws=_draws([tsims[2]]))
    _assert_bitwise(one[0], got[2])


#: An all-synergy grid: one admission rule for every lane, at loads that
#: admit different counts of jobs in the same quantum.
SYN_LANES = [
    (5, 1.0, "synergy", None),
    (13, 2.4, "synergy", None),
    (9, 1.6, "synergy", None),
]


def test_all_synergy_lanes_match_reference_and_single_runs(env):
    """A grid whose lanes all admit by synergy: each lane stops at its own
    trip count, so it equals the reference's lane and the port's single
    run of its scenario, and a sub-grid leaves it unchanged."""
    jsims = [_jsim(env, *lane) for lane in SYN_LANES]
    tsims = [_tsim(env, *lane) for lane in SYN_LANES]
    want = j_batched(jsims, QUANTA, warmup=False)
    got = run_device_sim_batched(tsims, QUANTA, warmup=False,
                                 draws=_draws(tsims))
    for sim, g, w in zip(tsims, got, want):
        assert g.n_completed > 0
        _assert_integer_logs_equal(g, w)
        np.testing.assert_allclose(_finish(g), _finish(w), rtol=1e-4)
        _assert_bitwise(g, run_device_sim(sim, QUANTA, warmup=False,
                                          draws=JaxDraws(sim.seed)))
    sub = tsims[:1]
    _assert_bitwise(run_device_sim_batched(sub, QUANTA, warmup=False,
                                           draws=_draws(sub))[0], got[0])


def test_syncs_do_not_grow_with_lanes(grid):
    """One fallback-flag read and one synergy trip-count read a quantum
    for the whole grid; the 2-opt's 8 refine rounds end at the check."""
    _, _, _, syncs = grid
    assert syncs == (QUANTA, 0, QUANTA)


def test_incompatible_lanes_are_refused(env):
    a = _tsim(env, 3, 1.4)
    others = [
        _tsim(env, 5, 1.4, n_cores=6),
        _tsim(env, 5, 1.4, tables=tmc.PhaseTables.build(env["tpool"])),
        _tsim(env, 5, 1.4, spec=dataclasses.replace(env["tspec"],
                                                    matcher="full")),
        _tsim(env, 5, 1.4, spec=tse.ScanPolicy(kind="adjacent")),
    ]
    for b in others:
        with pytest.raises(ValueError):
            run_device_sim_batched([a, b], 4, warmup=False)
    with pytest.raises(ValueError):
        run_device_sim_batched([], 4)
    # Rings are no reason to refuse a lane (open item 1 is ported).
    for kw in ({"telemetry": True}, {"app_telemetry": True}):
        assert run_device_sim_batched([a], 4, warmup=False, **kw)[
            0].telemetry.quanta == 4


@pytest.fixture(scope="module")
def race(env):
    """Both packages' closed races over the seed lanes, N = 16 and 15."""
    jpol = {"linux": jse.ScanPolicy(kind="linux"),
            "random": jse.ScanPolicy(kind="static"),
            "synpa4": env["jspec"]}
    tpol = {"linux": tse.ScanPolicy(kind="linux"),
            "random": tse.ScanPolicy(kind="static"),
            "synpa4": env["tspec"]}
    out = {}
    for n in (16, 15):
        jprofs = jwl.scaled_workload(16, seed=3)[:n]
        tprofs = twl.scaled_workload(16, seed=3)[:n]
        want = jse.run_quanta_multi_batched(
            env["jmach"], jprofs, jpol, RACE_SEEDS, n_quanta=RACE_QUANTA)
        got = tse.run_quanta_multi_batched(
            env["tmach"], tprofs, tpol, RACE_SEEDS, n_quanta=RACE_QUANTA,
            device="cpu", repeats=0,
            draws=tse.LaneDraws([JaxDraws(s) for s in RACE_SEEDS]))
        out[n] = (tprofs, tpol, got, want)
    return out


@pytest.mark.parametrize("n", [16, 15])
def test_seed_lanes_match_reference(race, n):
    _, tpol, got, want = race[n]
    for name in tpol:
        assert len(got[name]) == len(RACE_SEEDS)
        for g, w in zip(got[name], want[name]):
            assert g.n_apps == n and g.quanta == RACE_QUANTA
            np.testing.assert_allclose(g.total_retired, w.total_retired,
                                       rtol=1e-4, err_msg=name)
            np.testing.assert_allclose(g.mean_true_slowdown,
                                       w.mean_true_slowdown, rtol=1e-4,
                                       err_msg=name)
            np.testing.assert_allclose(g.ipc, w.ipc, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("n", [16, 15])
def test_seed_lanes_equal_run_quanta_scan(race, env, n):
    """Each seed lane is the port's single race of its seed, bit for bit;
    a one-lane batch too."""
    tprofs, tpol, got, _ = race[n]
    params = env["tmach"].params
    for i, seed in enumerate(RACE_SEEDS):
        single = tse.run_quanta_scan(params, tprofs, tpol,
                                     n_quanta=RACE_QUANTA, seed=seed,
                                     device="cpu", repeats=0,
                                     draws=JaxDraws(seed))
        for name in tpol:
            g, s = got[name][i], single[name]
            assert g.total_retired == s.total_retired, name
            assert g.mean_true_slowdown == s.mean_true_slowdown, name
            np.testing.assert_array_equal(g.ipc, s.ipc)
    one = tse.run_quanta_multi_batched(
        env["tmach"], tprofs, tpol, RACE_SEEDS[1:2], n_quanta=RACE_QUANTA,
        device="cpu", repeats=0,
        draws=tse.LaneDraws([JaxDraws(RACE_SEEDS[1])]))
    for name in tpol:
        assert one[name][0].total_retired == got[name][1].total_retired
        np.testing.assert_array_equal(one[name][0].ipc, got[name][1].ipc)


def test_batched_race_runs_on_cuda_unless_asked_for_the_cpu(env,
                                                            monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    profs = twl.scaled_workload(8, seed=8)
    pol = {"random": tse.ScanPolicy(kind="static")}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tse.run_quanta_multi_batched(env["tmach"], profs, pol, [1, 2],
                                     n_quanta=2)
    res = tse.run_quanta_multi_batched(env["tmach"], profs, pol, [1, 2],
                                       n_quanta=2, device="cpu", repeats=0)
    assert [r.n_apps for r in res["random"]] == [8, 8]
    ringed = tse.run_quanta_multi_batched(env["tmach"], profs, pol, [1],
                                          n_quanta=2, device="cpu",
                                          repeats=0, telemetry=True)
    assert ringed["random"][0].telemetry.data.shape == (2, 8)
    with pytest.raises(ValueError):
        tse.run_quanta_multi_batched(env["tmach"], profs, pol, [],
                                     n_quanta=2, device="cpu")

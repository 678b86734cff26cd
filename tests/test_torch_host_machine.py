"""Parity of the port's host machine (``repro_torch.smt.machine``, numpy)
with the reference's ``repro.smt.machine``, under the paper's baselines.

Both packages get the same workloads (the paper's 35, built by each
package's own ``make_workloads`` on a fresh machine, must be the same
lists) and the same seeds, and must give the same numbers bit for bit:
``run_workload`` on both engines (which are bit-identical to each other),
``run_quanta`` (even and odd populations), ``open_quantum`` and
``run_quanta_multi``, each under ``LinuxScheduler``, ``HySchedScheduler``,
``RandomStaticScheduler`` and ``OracleScheduler``.  The §6.2 metrics
(``run_repeated``, ``robust_mean``, ``speedup``, ``geomean``) and the
open-system aggregation (``bootstrap_ci``, ``GridStats``) are held the
same way.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import baselines as jb  # noqa: E402
from repro.smt import machine as jmc  # noqa: E402
from repro.smt import metrics as jmet  # noqa: E402
from repro.smt import workloads as jwl  # noqa: E402
from repro_torch.core import baselines as tb  # noqa: E402
from repro_torch.smt import machine as tmc  # noqa: E402
from repro_torch.smt import metrics as tmet  # noqa: E402
from repro_torch.smt import workloads as twl  # noqa: E402

BASELINES = ["LinuxScheduler", "HySchedScheduler", "RandomStaticScheduler",
             "OracleScheduler"]


@pytest.fixture(scope="module")
def wls():
    jw = jwl.make_workloads(jmc.SMTMachine(jmc.MachineParams(), seed=0))
    tw = twl.make_workloads(tmc.SMTMachine(tmc.MachineParams(), seed=0))
    return jw, tw


def test_workloads_match(wls):
    jw, tw = wls
    assert list(jw) == list(tw) and len(tw) == 35
    assert {k: list(v) for k, v in jw.items()} == \
        {k: list(v) for k, v in tw.items()}
    assert jwl.classify(jmc.SMTMachine(seed=0)) == \
        twl.classify(tmc.SMTMachine(seed=0))
    assert [p.name for p in twl.workload_profiles(tw["fb0"])] == \
        list(tw["fb0"])


def _same_workload_result(a, b):
    assert a.app_names == b.app_names
    assert (a.quanta, a.completed) == (b.quanta, b.completed)
    for f in ("turnaround_s", "solo_turnaround_s", "ipc"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.makespan_s, a.avg_turnaround_s, a.ipc_geomean) == \
        (b.makespan_s, b.avg_turnaround_s, b.ipc_geomean)


@pytest.mark.parametrize("engine", ["vector", "loop"])
@pytest.mark.parametrize("policy", BASELINES)
@pytest.mark.parametrize("workload", ["fb0", "be0", "fe0"])
def test_run_workload_matches(wls, engine, policy, workload):
    jw, tw = wls
    a = jmc.SMTMachine(seed=0).run_workload(
        jwl.workload_profiles(jw[workload]), getattr(jb, policy)(), seed=7,
        engine=engine)
    b = tmc.SMTMachine(seed=0).run_workload(
        twl.workload_profiles(tw[workload]), getattr(tb, policy)(), seed=7,
        engine=engine)
    _same_workload_result(a, b)
    assert b.completed and b.quanta > 20


@pytest.mark.parametrize("policy", BASELINES)
def test_engines_are_bit_identical(policy):
    profs = twl.scaled_workload(16, seed=3)
    m = tmc.SMTMachine(seed=0)
    _same_workload_result(
        m.run_workload(profs, getattr(tb, policy)(), seed=2,
                       max_quanta=60, engine="vector"),
        m.run_workload(profs, getattr(tb, policy)(), seed=2,
                       max_quanta=60, engine="loop"))


def _same_throughput(a, b):
    np.testing.assert_array_equal(a.ipc, b.ipc)
    assert (a.n_apps, a.quanta, a.total_retired, a.mean_true_slowdown) == \
        (b.n_apps, b.quanta, b.total_retired, b.mean_true_slowdown)


@pytest.mark.parametrize("n,policy", [(16, p) for p in BASELINES] + [
    (15, "LinuxScheduler"), (15, "RandomStaticScheduler")])
def test_run_quanta_matches(n, policy):
    """Odd populations: one app runs solo on a core each quantum (the
    reference's Hy-Sched and Oracle pair even populations only)."""
    jp = jwl.scaled_workload(16, seed=n)[:n]
    tp = twl.scaled_workload(16, seed=n)[:n]
    a = jmc.SMTMachine(seed=0).run_quanta(jp, getattr(jb, policy)(),
                                          n_quanta=12, seed=4)
    b = tmc.SMTMachine(seed=0).run_quanta(tp, getattr(tb, policy)(),
                                          n_quanta=12, seed=4)
    _same_throughput(a, b)
    assert b.sched_s_per_quantum >= 0 and b.machine_s_per_quantum > 0


def test_run_quanta_multi_matches():
    profs_j = jwl.scaled_workload(32, seed=1)
    profs_t = twl.scaled_workload(32, seed=1)
    pols = {"linux": "LinuxScheduler", "random": "RandomStaticScheduler",
            "hy": "HySchedScheduler", "oracle": "OracleScheduler"}
    a = jmc.SMTMachine(seed=0).run_quanta_multi(
        profs_j, {k: getattr(jb, v) for k, v in pols.items()}, n_quanta=10,
        seed=9)
    b = tmc.SMTMachine(seed=0).run_quanta_multi(
        profs_t, {k: getattr(tb, v) for k, v in pols.items()}, n_quanta=10,
        seed=9)
    assert list(a) == list(b)
    for k in a:
        _same_throughput(a[k], b[k])
    assert b["oracle"].mean_true_slowdown < b["random"].mean_true_slowdown


def test_run_quanta_multi_routes_scan():
    """``engine="scan"`` is the port's tensor race behind the same call."""
    from repro_torch.smt.scan_engine import ScanPolicy, run_quanta_scan

    profs = twl.scaled_workload(8, seed=2)
    pols = {"random": ScanPolicy(kind="static")}
    got = tmc.SMTMachine(seed=0).run_quanta_multi(
        profs, pols, n_quanta=3, seed=1, engine="scan", device="cpu",
        repeats=0)
    want = run_quanta_scan(tmc.MachineParams(), profs, pols, n_quanta=3,
                           seed=1, device="cpu", repeats=0)
    _same_throughput(got["random"], want["random"])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("speed", [False, True])
def test_open_quantum_matches(seed, speed):
    """Masked membership: pairs, a solo slot, empty slots, departures,
    a straggler speed vector; three quanta in a row."""
    from repro.smt.apps import pool_profiles as jpool
    from repro_torch.smt.apps import pool_profiles as tpool

    rng = np.random.default_rng(seed)
    c = 20
    jt, tt = jmc.PhaseTables.build(jpool()), tmc.PhaseTables.build(tpool())
    app_id = rng.integers(0, jt.n_apps, c)
    app_id[rng.choice(c, size=5, replace=False)] = -1
    states = []
    for mc in (jmc, tmc):
        st = mc._VectorState.empty(c)
        st.target[:] = rng.uniform(5e7, 4e8, c) if mc is jmc else \
            states[0].target.copy()
        st.phase_left[:] = 2.0
        states.append(st)
    occupied = np.flatnonzero(app_id >= 0)
    perm = rng.permutation(occupied)
    solo = perm[-1:] if perm.size % 2 else perm[:0]
    pairs = perm[: perm.size - solo.size].reshape(-1, 2)
    spd = rng.uniform(0.5, 1.0, c) if speed else None
    rj, rt = np.random.default_rng(seed + 99), np.random.default_rng(seed + 99)
    for q in range(3):
        out_j = jmc.SMTMachine(seed=0).open_quantum(
            jt, app_id, states[0], pairs, solo, rj, q, speed=spd)
        out_t = tmc.SMTMachine(seed=0).open_quantum(
            tt, app_id, states[1], pairs, solo, rt, q, speed=spd)
        for x, y in zip(out_j, out_t):
            np.testing.assert_array_equal(x, y)
    for f in ("phase_idx", "phase_left", "progress", "first_finish_q",
              "total_retired", "total_cycles"):
        np.testing.assert_array_equal(getattr(states[0], f),
                                      getattr(states[1], f))


def test_oracle_matrix_and_true_slowdown(wls):
    jw, tw = wls
    jp, tp = jwl.workload_profiles(jw["be0"]), twl.workload_profiles(tw["be0"])
    params = tmc.MachineParams()
    for pj, pt in zip(jp, tp):
        assert jmc.true_slowdown(pj.phase(0), pj, pt.phase(1), params) == \
            tmc.true_slowdown(pt.phase(0), pt, pt.phase(1), params)
    seen = []

    class Probe(tb.RandomStaticScheduler):
        def schedule(self, quantum, samples, prev_pairs):
            seen.append(self.machine.oracle_cost_matrix())
            return super().schedule(quantum, samples, prev_pairs)

    class JProbe(jb.RandomStaticScheduler):
        def schedule(self, quantum, samples, prev_pairs):
            seen.append(self.machine.oracle_cost_matrix())
            return super().schedule(quantum, samples, prev_pairs)

    jmc.SMTMachine(seed=0).run_workload(jp, JProbe(), seed=1, max_quanta=5)
    tmc.SMTMachine(seed=0).run_workload(tp, Probe(), seed=1, max_quanta=5)
    for x, y in zip(seen[:5], seen[5:]):
        np.testing.assert_array_equal(x, y)
    assert tmc.SMTMachine().oracle_cost_matrix() is None


def test_run_repeated_and_speedups(wls):
    jw, tw = wls
    a = jmet.run_repeated(jmc.SMTMachine(seed=0),
                          jwl.workload_profiles(jw["fb1"]),
                          jb.HySchedScheduler, repeats=3, base_seed=11)
    b = tmet.run_repeated(tmc.SMTMachine(seed=0),
                          twl.workload_profiles(tw["fb1"]),
                          tb.HySchedScheduler, repeats=3, base_seed=11)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    vals = np.array([1.0, 1.1, 0.9, 3.0, 1.05])
    np.testing.assert_array_equal(jmet.robust_mean(vals),
                                  tmet.robust_mean(vals))
    assert jmet.speedup(2.0, 1.5) == tmet.speedup(2.0, 1.5)
    assert jmet.geomean([1.2, 0.8, 1.5]) == tmet.geomean([1.2, 0.8, 1.5])


def test_bootstrap_and_grid_stats():
    rng = np.random.default_rng(0)
    vals = rng.lognormal(0.1, 0.3, 9)
    assert jmet.bootstrap_ci(vals, seed=4) == tmet.bootstrap_ci(vals, seed=4)
    assert tmet.bootstrap_ci([2.0]) == (2.0, 2.0, 2.0)

    def stats(pkg, k):
        jobs = [pkg.JobRecord(job_id=i, app_name="a", arrive_q=i, admit_q=i,
                              finish_q=i + 3.0 + k, target=1.0, solo_s=0.2)
                for i in range(5)]
        z = np.zeros(6)
        return pkg.OnlineStats("p", 0.1, 6, jobs, 5, 5, z, z + 3, z, z)

    gj, gt = jmet.GridStats(), tmet.GridStats()
    for k in range(3):
        gj.add("cell", stats(jmet, k))
        gt.add("cell", stats(tmet, k))
    assert gj.summary(n_boot=200) == gt.summary(n_boot=200)
    np.testing.assert_array_equal(gj.pooled_slowdowns("cell"),
                                  gt.pooled_slowdowns("cell"))

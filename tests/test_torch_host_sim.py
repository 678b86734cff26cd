"""Parity of the open system's host event loop
(``ClusterSim(engine="host", device="cpu")``, ``repro_torch.online.sim``)
and of the port's ``ft`` copies with the reference's, on the CPU.

Both packages run the same configuration (pool, Poisson arrivals, seed,
targets) at capacity 16 and 18 (capacities are two contexts a core, so
the odd populations come from churn: the idle-context convention), under
FIFO admission, synergy admission, and FIFO with faults (crash, recovery,
MTTF churn and stragglers, detected through ``HeartbeatMonitor`` and
``StragglerDetector`` on a quantum-index clock).  The machine stream
(``seed``), the arrival stream (``seed + 4242``) and the policy stream
(``seed + 7919``) are drawn in the reference's order, so the job logs,
the timelines and the fault detectors' verdicts must be equal, bit for
bit, under the online baselines and the streaming allocator.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.ft as jft  # noqa: E402
import repro.online as jon  # noqa: E402
from repro.core import isc as jisc  # noqa: E402
from repro.smt import machine as jmc  # noqa: E402
from repro.smt.apps import pool_profiles as jpool  # noqa: E402
import repro_torch.ft as tft  # noqa: E402
import repro_torch.online as ton  # noqa: E402
from repro_torch.core import isc as tisc  # noqa: E402
from repro_torch.smt import machine as tmc  # noqa: E402
from repro_torch.smt.apps import pool_profiles as tpool  # noqa: E402
from test_torch_allocator import same_stats  # noqa: E402
from test_torch_synpa_scheduler import models  # noqa: E402,F401

QUANTA, SEED = 40, 7


def _faults(pkg, n_cores):
    """The ``combined`` profile of the churn benchmarks' fault grid at this
    size: a crash wave and its recovery, MTTF churn, a straggler band."""
    k = max(1, n_cores // 8)
    crash = tuple((QUANTA // 4 + i % 3, i) for i in range(k))
    heal = tuple(((3 * QUANTA) // 4 + i % 3, i) for i in range(k))
    band = tuple((c, QUANTA // 3, (2 * QUANTA) // 3, 0.5)
                 for c in range(n_cores - max(1, n_cores // 8), n_cores))
    return pkg.FaultProfile(fail=crash, recover=heal, straggle=band,
                            mttf_quanta=3.0 * QUANTA, mttr_quanta=QUANTA / 6)


POLICIES = {
    "linux": lambda pkg, m: pkg.LinuxOnline(),
    "random": lambda pkg, m: pkg.RandomOnline(),
    "adjacent": lambda pkg, m: pkg.AdjacentOnline(),
    "stream": lambda pkg, m: (
        pkg.StreamingAllocator(jisc.SYNPA4_R_FEBE, m) if pkg is jon else
        pkg.StreamingAllocator(tisc.SYNPA4_R_FEBE, m, device="cpu")),
}
CASES = [(p, n_cores, mode) for p in POLICIES for n_cores in (8, 9)
         for mode in ("fifo", "synergy", "faults")
         if p != "stream" or n_cores == 8]


def _run(pkg, mc, pool, model, policy, n_cores, mode):
    kw = {}
    if mode == "synergy":
        method = jisc.SYNPA4_R_FEBE if pkg is jon else tisc.SYNPA4_R_FEBE
        kw = dict(admission="synergy", synergy=pkg.SynergyAdmission(
            mc.SMTMachine(seed=0), pool, method, model, quanta=12))
    elif mode == "faults":
        kw = dict(faults=_faults(pkg, n_cores))
    if pkg is ton:
        kw["device"] = "cpu"
    sim = pkg.ClusterSim(mc.SMTMachine(seed=0), pool, n_cores,
                         POLICIES[policy](pkg, model),
                         pkg.PoissonArrivals(rate=0.3 * n_cores,
                                             n_pool=len(pool)),
                         seed=SEED, target_scale=0.1, **kw)
    return sim.run(QUANTA)


@pytest.mark.parametrize("policy,n_cores,mode", CASES)
def test_host_loop_matches(models, policy, n_cores, mode):
    jm, tm = models
    a = _run(jon, jmc, jpool(), jm, policy, n_cores, mode)
    b = _run(ton, tmc, tpool(), tm, policy, n_cores, mode)
    same_stats(a, b)
    assert b.policy_name == a.policy_name
    assert b.n_completed > 0 and b.queue_depth.max() > 0
    assert b.solo_quanta.sum() > 0          # odd populations happened
    assert a.has_faults == b.has_faults == (mode == "faults")
    if mode == "faults":
        for f in ("failures", "recoveries", "evictions", "requeues",
                  "straggling", "straggler_flags"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (a.n_dropped, a.n_retry_waiting, a.n_in_flight) == \
            (b.n_dropped, b.n_retry_waiting, b.n_in_flight)
        assert b.evictions.sum() > 0 and b.straggler_flags.sum() > 0
        assert b.summary() == a.summary() | {
            k: b.summary()[k] for k in ("policy_us_per_quantum",
                                        "policy_us_per_quantum_median")}


def test_host_loop_refuses_device_knobs():
    pool = tpool()
    sim = ton.ClusterSim(tmc.SMTMachine(seed=0), pool, 2, ton.LinuxOnline(),
                         ton.PoissonArrivals(rate=1.0, n_pool=len(pool)),
                         device="cpu")
    for kw in ({"repeats": 2}, {"telemetry": True}, {"draws": object()}):
        with pytest.raises(ValueError, match="device-engine"):
            sim.run(3, **kw)


@pytest.mark.parametrize("seed", range(4))
def test_heartbeat_and_straggler_verdicts_match(seed):
    """The ``ft`` state machines on a random event sequence: the same
    verdicts, EWMAs and shares."""
    rng = np.random.default_rng(seed)
    hosts = [f"h{k}" for k in range(6)]
    mons = [jft.HeartbeatMonitor(list(hosts), timeout_s=1.5),
            tft.HeartbeatMonitor(list(hosts), timeout_s=1.5)]
    dets = [jft.StragglerDetector(list(hosts), patience=2),
            tft.StragglerDetector(list(hosts), patience=2)]
    for m in mons:
        for h in hosts:
            m.admit(h, now=0.0)
    for t in range(1, 30):
        beats = [h for h in hosts if rng.random() < 0.8]
        rejoin = [h for h in hosts if rng.random() < 0.1]
        times = {h: float(rng.lognormal(0.0, 0.5)) for h in hosts
                 if rng.random() < 0.9}
        out = []
        for m, d in zip(mons, dets):
            for h in beats:
                m.beat(h, now=float(t))
            for h in rejoin:
                if h in m.dead:
                    m.admit(h, now=float(t))
            out.append((sorted(m.check(now=float(t))), m.alive,
                        sorted(m.dead), d.observe(times),
                        [d.ewma(h) for h in hosts]))
        assert out[0] == out[1]
    ew = {h: dets[0].ewma(h) or 1.0 for h in hosts}
    assert jft.rebalanced_shares(hosts, ew, 37) == \
        tft.rebalanced_shares(hosts, ew, 37)
    with pytest.raises(KeyError):
        mons[1].beat("nobody", now=1.0)


def test_elastic_replan_matches():
    groups = {f"g{k}": [f"h{2 * k}", f"h{2 * k + 1}"] for k in range(8)}
    for dead, pods in ((["h3"], 1), (["h0", "h9", "h15"], 2), ([], 2)):
        a = jft.replan_after_failure(groups, dead, 2, 4, 2, pods)
        b = tft.replan_after_failure(groups, dead, 2, 4, 2, pods)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.mesh_shape, a.mesh_axes, a.n_devices) == \
            (b.mesh_shape, b.mesh_axes, b.n_devices)
    with pytest.raises(RuntimeError):
        tft.replan_after_failure(groups, [f"h{k}" for k in range(16)], 2, 4)

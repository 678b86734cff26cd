"""Parity of the port's streaming allocator
(``repro_torch.online.allocator``: ``StreamingAllocator``,
``StreamingScheduler``, the ``StreamingConfig`` presets) with the
reference's, on the CPU.

Both packages' allocators are driven through the open system's host event
loop (``ClusterSim(engine="host")``, capacity 16, Poisson arrivals, the
same seed: the same churn, departures and odd populations) with the same
fitted ``SYNPA4_R-FEBE`` coefficients, and through the closed machine as
``StreamingScheduler``.  Every ``pair`` call must return the reference's
pairs and solo slot, and the runs' job logs must be equal: the default
config, ``cold_config``, ``exact_config``, ``rematch="refine"``, the
heavy-ball solver warm-started, synergy admission's ST hints.  The device
matcher (``matcher="device"``) ranks vertices by float32 degree sums, which
each library adds in its own order, so where two matchings tie it may take
the other one (ROADMAP §3): at the first call where the pairs differ, the
two matchings must cost the same within 1e-6 relative under the
reference's matrix.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.online as jon  # noqa: E402
from repro.core import isc as jisc  # noqa: E402
from repro.smt import machine as jmc  # noqa: E402
from repro.smt import workloads as jwl  # noqa: E402
from repro.smt.apps import pool_profiles as jpool  # noqa: E402
import repro_torch.online as ton  # noqa: E402
from repro_torch.core import isc as tisc  # noqa: E402
from repro_torch.core import synpa as tsyn  # noqa: E402
from repro_torch.smt import machine as tmc  # noqa: E402
from repro_torch.smt import workloads as twl  # noqa: E402
from repro_torch.smt.apps import pool_profiles as tpool  # noqa: E402
from test_torch_synpa_scheduler import first_flip, models, record  # noqa: E402,F401

N_CORES, QUANTA, SEED, RATE = 8, 30, 5, 2.0


def same_stats(a, b):
    """Two host runs' ``OnlineStats`` equal: job logs and timelines."""
    assert (a.n_arrived, a.n_admitted, a.n_completed) == \
        (b.n_arrived, b.n_admitted, b.n_completed)
    assert [(r.job_id, r.app_name, r.arrive_q, r.admit_q, r.retries,
             r.finish_q, r.target, r.solo_s) for r in a.completed] == \
        [(r.job_id, r.app_name, r.arrive_q, r.admit_q, r.retries, r.finish_q,
          r.target, r.solo_s) for r in b.completed]
    for f in ("queue_depth", "active", "solo_quanta", "arrivals",
              "admissions", "departures"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def run_both(jpol, tpol, **kw):
    """The same open run, capacity 16, in both packages; ``kw`` builds the
    extra arguments of each side (``lambda pkg, mc, pool, model``)."""
    out = []
    for pkg, mc, pool, pol in ((jon, jmc, jpool(), jpol),
                               (ton, tmc, tpool(), tpol)):
        extra = {k: v(pkg, mc, pool) for k, v in kw.items()}
        dev = {} if pkg is jon else {"device": "cpu"}
        sim = pkg.ClusterSim(
            mc.SMTMachine(seed=0), pool, N_CORES, pol,
            pkg.PoissonArrivals(rate=RATE, n_pool=len(pool)), seed=SEED,
            target_scale=0.1, **dev, **extra)
        out.append(sim.run(QUANTA))
    return out


def _synergy(models):
    jm, tm = models

    def make(pkg, mc, pool):
        method = jisc.SYNPA4_R_FEBE if pkg is jon else tisc.SYNPA4_R_FEBE
        return pkg.SynergyAdmission(mc.SMTMachine(seed=0), pool, method,
                                    jm if pkg is jon else tm, quanta=12)
    return make


CONFIGS = {
    "default": lambda pkg: None,
    "cold": lambda pkg: pkg.cold_config(),
    "exact": lambda pkg: pkg.exact_config(),
    "refine": lambda pkg: pkg.StreamingConfig(rematch="refine"),
    "hb-warm": lambda pkg: pkg.StreamingConfig(solver="hb", warm=True),
}


@pytest.mark.parametrize("config,admission", [
    (c, "fifo") for c in CONFIGS] + [
    (c, "synergy") for c in ("default", "exact", "hb-warm")])
def test_streaming_allocator_matches(models, config, admission):
    jm, tm = models
    ja = jon.StreamingAllocator(jisc.SYNPA4_R_FEBE, jm, CONFIGS[config](jon))
    ta = ton.StreamingAllocator(tisc.SYNPA4_R_FEBE, tm, CONFIGS[config](ton),
                                device="cpu")
    assert ja.name == ta.name
    jlog, tlog = record(ja, "pair", ref=True), record(ta, "pair")
    kw = {}
    if admission == "synergy":
        kw = dict(admission=lambda *a: "synergy", synergy=_synergy(models))
    copies = tsyn.HOST_COST_COPIES
    a, b = run_both(ja, ta, **kw)
    assert first_flip(jlog, tlog, pairs_of=lambda out: out[0]) is None
    same_stats(a, b)
    assert b.solo_quanta.sum() > 0 and b.n_completed > 0
    steps = sum(c is not None for _, c in tlog)
    assert steps == len(ta.timings) > QUANTA // 2
    # One host copy of the cost matrix a step (a lone app needs none).
    assert tsyn.HOST_COST_COPIES - copies == steps - sum(
        1 for out, c in tlog if c is not None and not out[0])


def test_device_matcher_matches_up_to_a_tie(models):
    jm, tm = models
    ja = jon.StreamingAllocator(jisc.SYNPA4_R_FEBE, jm,
                                jon.StreamingConfig(matcher="device"))
    ta = ton.StreamingAllocator(tisc.SYNPA4_R_FEBE, tm,
                                ton.StreamingConfig(matcher="device"),
                                device="cpu")
    jlog, tlog = record(ja, "pair", ref=True), record(ta, "pair")
    from repro_torch.core import matching as tmat

    copies = tmat.HOST_PARTNER_COPIES
    run_both(ja, ta)
    flip = first_flip(jlog, tlog, pairs_of=lambda out: out[0])
    upto = len(tlog) if flip is None else flip[0]
    assert upto > QUANTA // 4
    # Every step before the flip copied one partner vector back, no matrix.
    assert tmat.HOST_PARTNER_COPIES - copies >= sum(
        1 for out, c in tlog[:upto] if c is not None and out[0])


def test_hints_seed_the_device_state(models):
    """Synergy hints land in the ST state (an ``index_put_``) and keep the
    hinted newcomer from the fresh-mask reset, as in the reference."""
    jm, tm = models
    ja = jon.StreamingAllocator(jisc.SYNPA4_R_FEBE, jm)
    ta = ton.StreamingAllocator(tisc.SYNPA4_R_FEBE, tm, device="cpu")
    rng = np.random.default_rng(0)
    ja.reset(None, np.random.default_rng(1))
    ta.reset(None, np.random.default_rng(1))
    ja._ensure_state(16)
    ta._ensure_state(16)
    hints = {3: rng.dirichlet(np.ones(4)), 9: rng.dirichlet(np.ones(4)),
             12: rng.dirichlet(np.ones(4))}
    assert ja._apply_hints(hints, {3, 12}) == ta._apply_hints(hints, {3, 12})
    np.testing.assert_array_equal(ta._st.numpy(), np.asarray(ja._st))


@pytest.mark.parametrize("config,population", [("default", "fb3"),
                                               ("cold", 16), ("refine", 16)])
def test_streaming_scheduler_matches(models, config, population):
    """The closed-system adapter on the paper's N = 8 workload ``fb3`` and
    on a 16-app cluster population."""
    jm, tm = models
    js = jon.StreamingScheduler(jisc.SYNPA4_R_FEBE, jm, CONFIGS[config](jon))
    ts = ton.StreamingScheduler(tisc.SYNPA4_R_FEBE, tm, CONFIGS[config](ton),
                                device="cpu")
    jlog, tlog = record(js), record(ts)
    if isinstance(population, str):
        names = jwl.make_workloads(jmc.SMTMachine(seed=0))[population]
        assert names == twl.make_workloads(tmc.SMTMachine(seed=0))[population]
        a = jmc.SMTMachine(seed=0).run_workload(
            jwl.workload_profiles(names), js, seed=4)
        b = tmc.SMTMachine(seed=0).run_workload(
            twl.workload_profiles(names), ts, seed=4)
        np.testing.assert_array_equal(a.turnaround_s, b.turnaround_s)
    else:
        a = jmc.SMTMachine(seed=0).run_quanta(
            jwl.scaled_workload(population, seed=2), js, n_quanta=10, seed=1)
        b = tmc.SMTMachine(seed=0).run_quanta(
            twl.scaled_workload(population, seed=2), ts, n_quanta=10, seed=1)
        assert a.mean_true_slowdown == b.mean_true_slowdown
    assert [o for o, _ in jlog] == [o for o, _ in tlog]
    assert ts.name == js.name

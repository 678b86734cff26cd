"""Parity of the port's host-tier SYNPA (``repro_torch.core.synpa``:
``SynpaScheduler``, ``make_synpa_pipeline``), the paper's baselines
(``repro_torch.core.baselines``) and the §5.3 inverse's entry points
(``repro_torch.core.regression.inverse``, ``inverse_trace``,
``inverse_gn_trace``, ``make_fused_step(solver="hb", warm=True)``) with the
reference's, on the CPU.

Both packages get the same fitted ``SYNPA4_R-FEBE`` coefficients and the
same workloads and seeds.  The machine is numpy in both, so the runs stay
equal as long as the pairings do: ``SynpaScheduler`` must choose the
reference's pairing in every quantum on the paper's workloads (N = 8) and
on an odd cluster population (N = 15, the idle vertex), with equal
turnaround.  The two packages' float32 costs differ in the last bits (the
GN solve's order), and the blossom rounds costs to integers, so a pairing
could flip at a rounding boundary: the check then shows the two matchings
cost the same within 1e-6 relative under the reference's matrix (ROADMAP
§3, "Parity limits").  The baselines are numpy in both: bit for bit.
Stacks from the inverse are held to the limits already in ROADMAP §3:
1e-5, and 1e-4 on rows that stopped on a plateau.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import baselines as jb  # noqa: E402
from repro.core import isc as jisc  # noqa: E402
from repro.core import regression as jreg  # noqa: E402
from repro.core import synpa as jsyn  # noqa: E402
from repro.smt import machine as jmc  # noqa: E402
from repro.smt import training as jtr  # noqa: E402
from repro.smt import workloads as jwl  # noqa: E402
from repro_torch.convert import category_model_from_numpy  # noqa: E402
from repro_torch.core import baselines as tb  # noqa: E402
from repro_torch.core import isc as tisc  # noqa: E402
from repro_torch.core import matching as tmat  # noqa: E402
from repro_torch.core import regression as treg  # noqa: E402
from repro_torch.core import synpa as tsyn  # noqa: E402
from repro_torch.smt import machine as tmc  # noqa: E402
from repro_torch.smt import workloads as twl  # noqa: E402


@pytest.fixture(scope="module")
def models():
    """The reference's fitted SYNPA4_R-FEBE model and its port twin."""
    jmodels, _ = jtr.build_all_models(
        jmc.SMTMachine(jmc.MachineParams(), seed=0),
        methods={"SYNPA4_R-FEBE": jisc.SYNPA4_R_FEBE})
    jm = jmodels["SYNPA4_R-FEBE"]
    tm = category_model_from_numpy(np.asarray(jm.coeffs), np.asarray(jm.mse),
                                   jm.n_categories, device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def wls():
    return (jwl.make_workloads(jmc.SMTMachine(jmc.MachineParams(), seed=0)),
            twl.make_workloads(tmc.SMTMachine(tmc.MachineParams(), seed=0)))


def record(policy, method="schedule", ref=False):
    """Log every call of ``policy.<method>`` as ``(result, cost)``, with
    ``cost`` the host copy of the prepared matrix the call's fused step
    made (``None`` when the call ran no step)."""
    log, last = [], []
    if hasattr(policy, "_step"):
        step = policy._step

        def logged_step(*args):
            out = step(*args)
            last.append(np.asarray(out[0]) if ref else out[0].numpy())
            return out

        policy._step = logged_step
    inner = getattr(policy, method)

    def logged(*args, **kw):
        out = inner(*args, **kw)
        log.append((out, last.pop() if last else None))
        return out

    setattr(policy, method, logged)
    return log


def _pairs_cost(cost, pairs):
    return sum(float(cost[a, b]) for a, b in pairs)


def first_flip(jlog, tlog, pairs_of=lambda out: out):
    """``(call index, relative cost gap)`` of the first call whose pairing
    differs, ``None`` if every call agrees.  At a flip the two matchings
    must cost the same within 1e-6 relative under the reference's matrix:
    a flip between two equally good matchings (ROADMAP §3), not a
    different decision.  The runs part ways there, so nothing after it is
    compared."""
    assert len(jlog) == len(tlog)
    for q, ((jout, jcost), (tout, _)) in enumerate(zip(jlog, tlog)):
        if jout == tout:
            continue
        a = _pairs_cost(jcost, pairs_of(jout))
        b = _pairs_cost(jcost, pairs_of(tout))
        gap = abs(a - b) / abs(a)
        assert gap <= 1e-6, (q, a, b)
        return q, gap
    return None


@pytest.mark.parametrize("workload", ["fb0", "be0", "fe0"])
def test_synpa_scheduler_matches_on_paper_workloads(models, wls, workload):
    jm, tm = models
    jw, tw = wls
    js = jsyn.SynpaScheduler(jisc.SYNPA4_R_FEBE, jm)
    ts = tsyn.SynpaScheduler(tisc.SYNPA4_R_FEBE, tm, device="cpu")
    jlog, tlog = record(js, ref=True), record(ts)
    copies = tsyn.HOST_COST_COPIES
    a = jmc.SMTMachine(seed=0).run_workload(
        jwl.workload_profiles(jw[workload]), js, seed=101)
    b = tmc.SMTMachine(seed=0).run_workload(
        twl.workload_profiles(tw[workload]), ts, seed=101)
    assert first_flip(jlog, tlog) is None
    np.testing.assert_array_equal(a.turnaround_s, b.turnaround_s)
    np.testing.assert_array_equal(a.ipc, b.ipc)
    steps = sum(c is not None for _, c in tlog)
    assert steps == a.quanta - 1 == len(ts.timings)
    assert tsyn.HOST_COST_COPIES == copies + steps
    assert ts.name == js.name == "SYNPA4_R-FEBE"


@pytest.mark.parametrize("n", [15, 64])
def test_synpa_scheduler_matches_on_cluster_populations(models, n):
    """N = 15 (odd: the idle vertex, one app solo a quantum) and N = 64,
    through ``run_quanta``; the blossom tier in both.  At N = 64 (a clone
    population: 64 draws from 24 pool apps, so many matchings tie) the
    pairing flips at quantum 3 between two matchings of the same cost
    under the reference's matrix (gap below 1e-6 relative): the parity
    limit of ROADMAP §3.  The runs agree up to there."""
    jm, tm = models
    js = jsyn.SynpaScheduler(jisc.SYNPA4_R_FEBE, jm)
    ts = tsyn.SynpaScheduler(tisc.SYNPA4_R_FEBE, tm, device="cpu")
    jlog, tlog = record(js, ref=True), record(ts)
    a = jmc.SMTMachine(seed=0).run_quanta(
        jwl.scaled_workload(n + n % 2, seed=n)[:n], js, n_quanta=8, seed=3)
    b = tmc.SMTMachine(seed=0).run_quanta(
        twl.scaled_workload(n + n % 2, seed=n)[:n], ts, n_quanta=8, seed=3)
    flip = first_flip(jlog, tlog)
    if n == 64:
        assert flip is not None and flip[0] == 3, flip
        return
    assert flip is None
    assert (a.total_retired, a.mean_true_slowdown) == \
        (b.total_retired, b.mean_true_slowdown)
    if n % 2:
        assert all(len(out) == n // 2 for out, _ in tlog)


def test_tiled_matcher_and_odd_idle_vertex(models):
    """The tiled tier (``matcher="tiled"``) at N = 64 on one quantum's
    costs; the port's pairs are the reference's on its own matrix."""
    jm, tm = models
    js = jsyn.SynpaScheduler(jisc.SYNPA4_R_FEBE, jm, matcher="tiled")
    ts = tsyn.SynpaScheduler(tisc.SYNPA4_R_FEBE, tm, matcher="tiled",
                             device="cpu")
    jlog, tlog = record(js, ref=True), record(ts)
    jmc.SMTMachine(seed=0).run_quanta(jwl.scaled_workload(64, seed=5), js,
                                      n_quanta=4, seed=2)
    tmc.SMTMachine(seed=0).run_quanta(twl.scaled_workload(64, seed=5), ts,
                                      n_quanta=4, seed=2)
    assert first_flip(jlog, tlog) is None
    for (_, tcost) in tlog[1:]:
        assert tmat.min_cost_pairs(tcost[:64, :64], "tiled") == \
            jsyn.matching.min_cost_pairs(tcost[:64, :64], "tiled")


@pytest.mark.parametrize("n", [8, 16, 33])
def test_pipeline_matches(models, n):
    jm, tm = models
    rng = np.random.default_rng(n)
    params = tmc.MachineParams()
    tables = tmc.PhaseTables.build(twl.scaled_workload(n + n % 2,
                                                       seed=n)[:n])
    idx = np.arange(n)
    partner = tsyn._partner_index(
        [tuple(p) for p in rng.permutation(n)[: n - n % 2].reshape(-1, 2)],
        n)
    ph = rng.integers(0, tables.n_phases)
    comps = tmc.corun_components_batched(tables, idx, ph, partner,
                                         ph[partner], params)
    counters = tmc.pmu_counters_batched(
        comps, tables.omega, tables.retire, params.quantum_cycles, params,
        rng).astype(np.float32)
    want_c, want_s = jsyn.make_synpa_pipeline(jisc.SYNPA4_R_FEBE, jm)(
        jnp.asarray(counters), jnp.asarray(partner))
    got_c, got_s = tsyn.make_synpa_pipeline(tisc.SYNPA4_R_FEBE, tm,
                                            device="cpu")(counters, partner)
    want_c, want_s = np.asarray(want_c), np.asarray(want_s)
    assert got_c.shape == want_c.shape == (n, n)
    big = want_c == jsyn.matching.BIG
    np.testing.assert_array_equal(got_c.numpy() == tmat.BIG, big)
    np.testing.assert_allclose(got_c.numpy()[~big], want_c[~big], rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=1e-4)


@pytest.mark.parametrize("policy", ["LinuxScheduler", "HySchedScheduler",
                                    "RandomStaticScheduler",
                                    "OracleScheduler"])
def test_baselines_match_every_quantum(wls, policy):
    jw, tw = wls
    jp, tp = getattr(jb, policy)(), getattr(tb, policy)()
    jlog, tlog = record(jp, ref=True), record(tp)
    jmc.SMTMachine(seed=0).run_workload(
        jwl.workload_profiles(jw["fb2"]), jp, seed=3)
    tmc.SMTMachine(seed=0).run_workload(
        twl.workload_profiles(tw["fb2"]), tp, seed=3)
    assert [o for o, _ in jlog] == [o for o, _ in tlog]
    assert jp.name == tp.name


def _fracs(seed, n):
    """Measured stack fractions of ``n`` co-running pairs, from the
    machine's counter model."""
    rng = np.random.default_rng(seed)
    params = tmc.MachineParams()
    tables = tmc.PhaseTables.build(twl.scaled_workload(2 * n, seed=seed))
    i, j = np.arange(n), np.arange(n, 2 * n)
    ph = rng.integers(0, tables.n_phases)
    out = []
    for a, b in ((i, j), (j, i)):
        comps = tmc.corun_components_batched(tables, a, ph[a], b, ph[b],
                                             params)
        c = tmc.pmu_counters_batched(comps, tables.omega[a],
                                     tables.retire[a], params.quantum_cycles,
                                     params, rng).astype(np.float32)
        out.append(np.array(jisc.build_stack_from_counters(
            *(c[:, k] for k in range(4)), jisc.SYNPA4_R_FEBE), np.float32))
    return out


def _assert_stacks(jm, fi, fj, got, want, unconverged=1e-4):
    """1e-5, or ``unconverged`` on a pair whose reference solve did not
    reach the solver's 1e-4 "good enough" residual: 1e-4 for a GN row
    stopped on a plateau; for a cold heavy-ball row 5e-3 (ROADMAP §3: the
    heavy-ball iteration amplifies the two packages' float orders on rows
    it has not solved)."""
    res = np.asarray(jreg.inverse_residual(jm, fi, fj, want[0], want[1]))
    plateau = res >= jreg._GN_GOOD_ENOUGH
    for g, w in zip(got, want):
        err = np.abs(g.numpy() - np.asarray(w)).max(-1)
        np.testing.assert_array_less(err[~plateau], 1e-5)
        np.testing.assert_array_less(err[plateau], unconverged)


@pytest.mark.parametrize("solver", ["gn", "hb"])
@pytest.mark.parametrize("warm", [False, True])
def test_inverse_matches(models, solver, warm):
    """``n_steps=24``: the streaming allocator's heavy-ball budget
    (``StreamingConfig.warm_steps``); under ``"gn"`` the fallback's."""
    jm, tm = models
    fi, fj = _fracs(5, 48)
    kw = {}
    if warm:
        rng = np.random.default_rng(6)
        kw = dict(init_i=rng.dirichlet(np.ones(4), 48).astype(np.float32),
                  init_j=rng.dirichlet(np.ones(4), 48).astype(np.float32))
    want = jreg.inverse(jm, fi, fj, solver=solver, n_steps=24,
                        return_diag=True, **kw)
    got = treg.inverse(tm, fi, fj, solver=solver, n_steps=24,
                       return_diag=True, device="cpu", **kw)
    cold_hb = solver == "hb" and not warm
    _assert_stacks(jm, fi, fj, got[:2], want[:2],
                   5e-3 if cold_hb else 1e-4)
    np.testing.assert_array_equal(got[2].iters.numpy(),
                                  np.asarray(want[2].iters))
    np.testing.assert_array_equal(got[2].fallback.numpy(),
                                  np.asarray(want[2].fallback))
    plain = treg.inverse(tm, fi, fj, solver=solver, n_steps=24,
                         device="cpu", **kw)
    np.testing.assert_array_equal(plain[0].numpy(), got[0].numpy())


@pytest.mark.parametrize("warm", [False, True])
def test_inverse_traces_match(models, warm):
    jm, tm = models
    fi, fj = _fracs(8, 32)
    kw = dict(init_i=fj, init_j=fi) if warm else {}
    for jfn, tfn, steps in ((jreg.inverse_trace, treg.inverse_trace, 24),
                            (jreg.inverse_gn_trace, treg.inverse_gn_trace,
                             8)):
        wi, wj, wt = jfn(jm, fi, fj, n_steps=steps, **kw)
        gi, gj, gt = tfn(tm, fi, fj, n_steps=steps, device="cpu", **kw)
        assert gt.shape == (steps, 32)
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=1e-3,
                                   atol=1e-7)
        _assert_stacks(jm, fi, fj, (gi, gj), (wi, wj))


@pytest.mark.parametrize("n", [8, 15])
def test_fused_step_hb_warm_matches(models, n):
    """``make_fused_step(solver="hb", warm=True)``: the streaming
    allocator's heavy-ball arm, warm-started from the carried ST."""
    jm, tm = models
    from test_torch_synpa import _assert_cost_close, _inputs

    counters, partner, prev_st, masks, idle = _inputs(n, n, True)
    args_j = (jnp.asarray(counters), jnp.asarray(partner.astype(np.int32)),
              jnp.asarray(prev_st), jnp.asarray(masks), jnp.asarray(idle))
    args_t = (torch.as_tensor(counters), torch.as_tensor(partner),
              torch.as_tensor(prev_st), torch.as_tensor(masks), idle)
    for warm in (True, False):
        jc, js = jsyn.make_fused_step(jisc.SYNPA4_R_FEBE, jm, impl="xla",
                                      solver="hb", hb_steps=24,
                                      warm=warm)(*args_j)
        tc, ts = tsyn.make_fused_step(tisc.SYNPA4_R_FEBE, tm, solver="hb",
                                      hb_steps=24, warm=warm)(*args_t)
        _assert_cost_close(tc.numpy(), np.asarray(jc))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4)


def test_backend_keyword_is_auto_only(models):
    _, tm = models
    for make in (lambda: tsyn.make_fused_step(tisc.SYNPA4_R_FEBE, tm,
                                              impl="pallas"),
                 lambda: tsyn.SynpaScheduler(tisc.SYNPA4_R_FEBE, tm,
                                             pair_impl="xla", device="cpu"),
                 lambda: tsyn.make_synpa_pipeline(tisc.SYNPA4_R_FEBE, tm,
                                                  impl="xla", device="cpu")):
        with pytest.raises(ValueError, match="auto"):
            make()
    with pytest.raises(ValueError, match="solver"):
        tsyn.make_fused_step(tisc.SYNPA4_R_FEBE, tm, solver="adam")
